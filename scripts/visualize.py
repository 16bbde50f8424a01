#!/usr/bin/env python
"""Render a registration result: before/after scatter panels -> PNG.

The reference delegated visualization to a companion repo and demo GIFs
(/root/reference/README.md:11-19); this renders the same story offline.

Usage:
    # from a run config + its [io] output toml:
    python scripts/visualize.py -c configs/bunny.toml -r result.toml -o out.png
    # or register on the spot:
    python scripts/visualize.py -c configs/bunny.toml --run -o out.png
"""

from __future__ import annotations

import argparse
import os
import sys
import tomllib

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from fgoicp.config import Config                     # noqa: E402
from fgoicp.io import load_cloud                     # noqa: E402


def render(pct, pcs, R, t, out_path, title=""):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    aligned = pcs @ np.asarray(R, np.float32).T + np.asarray(t, np.float32)
    fig = plt.figure(figsize=(12, 4.2))
    for i, (src, label) in enumerate(
            [(pcs, "before"), (aligned, "after")], start=1):
        ax = fig.add_subplot(1, 2, i, projection="3d")
        ax.scatter(*pct.T, s=1, c="#9aa4b2", alpha=0.5, label="target")
        ax.scatter(*src.T, s=1, c="#d1495b", alpha=0.7, label="source")
        ax.set_title(f"{label}")
        ax.set_axis_off()
        ax.legend(loc="upper right", markerscale=6, fontsize=8)
    fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=140)
    print(f"wrote {out_path}")


def render_animation(pct, pcs, frames, out_path, fps=2):
    """Convergence animation: one frame per incumbent improvement, the
    reference's demo-GIF story (imgs/fgoicp-bunny.gif; the
    get_last_transform getter exists for exactly this, fgoicp.hpp:32-43).

    frames: [(label, R, t_world)] in chronological order.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation

    fig = plt.figure(figsize=(6, 5.2))
    ax = fig.add_subplot(111, projection="3d")

    def draw(i):
        label, R, t = frames[min(i, len(frames) - 1)]
        ax.clear()
        aligned = pcs @ np.asarray(R, np.float32).T + np.asarray(t, np.float32)
        ax.scatter(*pct.T, s=1, c="#9aa4b2", alpha=0.5, label="target")
        ax.scatter(*aligned.T, s=1, c="#d1495b", alpha=0.7, label="source")
        ax.set_title(label)
        ax.set_axis_off()
        ax.legend(loc="upper right", markerscale=6, fontsize=8)
        return []

    # Hold the final pose for a few frames so the loop point reads clearly.
    anim = animation.FuncAnimation(
        fig, draw, frames=len(frames) + 3, interval=1000 / fps, blit=False)
    anim.save(out_path, writer=animation.PillowWriter(fps=fps))
    print(f"wrote {out_path} ({len(frames)} incumbent frames)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-r", "--result", default="",
                   help="result TOML written by the CLI ([io] output)")
    p.add_argument("--run", action="store_true",
                   help="run the registration now instead of reading -r")
    p.add_argument("-o", "--out", default="registration.png")
    p.add_argument("--animate", default="",
                   help="also write a convergence GIF from the incumbent "
                        "history (requires --run)")
    args = p.parse_args(argv)
    if args.animate and not args.run:
        p.error("--animate needs --run (the incumbent history is only "
                "recorded during a live registration)")

    cfg = Config.from_toml(args.config)
    pct = load_cloud(cfg.io.target, cfg.params.target_subsample,
                     seed=cfg.engine.seed)
    pcs = load_cloud(cfg.io.source, cfg.params.source_subsample,
                     seed=cfg.engine.seed + 1)

    if args.run:
        from fgoicp.models.goicp import GoICP
        model = GoICP(pct, pcs, lut_resolution=cfg.params.lut_resolution,
                      mse_threshold=cfg.params.mse_threshold,
                      engine=cfg.engine)
        R, t = model.run()
        title = f"mse={model.mse:.2e}"
        if args.animate:
            import jax.numpy as jnp
            frames = [("initial", np.eye(3, dtype=np.float32),
                       np.zeros(3, np.float32))]
            # History entries are in the normalized frame; the rotation is
            # frame-invariant, translations de-normalize like run() does.
            for (elapsed, sse, Rh, th) in model.history:
                tw = np.asarray(model.norm.restore_translation(
                    jnp.asarray(Rh), jnp.asarray(th)))
                frames.append(
                    (f"t={elapsed:.2f}s  sse={sse:.3g}", Rh, tw))
            render_animation(pct, pcs, frames, args.animate)
    else:
        if not args.result:
            p.error("provide -r RESULT.toml or --run")
        with open(args.result, "rb") as f:
            res = tomllib.load(f)["result"]
        R = np.asarray(res["rotation"], np.float32)
        t = np.asarray(res["translation"], np.float32)
        title = f"mse={res['mse']:.2e}"

    render(pct, pcs, np.asarray(R), np.asarray(t), args.out, title)
    return 0


if __name__ == "__main__":
    sys.exit(main())
