"""Experiment runner for the HARD Stanford bunny scan pairs.

The classic Go-ICP evaluation regime: turntable
scans 90 degrees apart and partial views with low overlap, where seeding
cannot certify and the trimmed BnB must do real work.  Ground truth
comes from the published Stanford registration .conf (not shipped in
/root/reference/data/bunny/, but the scanner geometry is public):

  bun090: ~90.2 deg about -y (pure turntable)
  chin:   ~58.6 deg about axis ~(-0.90, 0.43, 0.01), t ~ (4, 88, -109) mm

    python scripts/hard_pairs.py [--pair 090|chin] [--trim 0.5]
        [--subsample 0.25] [--mse 1e-4] [--device-outer]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, ".")

DATA = "/root/reference/data/bunny"


def axis_angle(R):
    ang = np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)))
    axis = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                     R[1, 0] - R[0, 1]])
    n = np.linalg.norm(axis)
    return ang, (axis / n if n > 1e-9 else axis)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pair", default="090", choices=["090", "chin", "045"])
    ap.add_argument("--trim", type=float, default=0.5)
    ap.add_argument("--subsample", type=float, default=0.25)
    ap.add_argument("--tgt-subsample", type=float, default=0.5)
    ap.add_argument("--mse", type=float, default=1e-4)
    ap.add_argument("--device-outer", action="store_true")
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args()

    from fgoicp.config import EngineConfig
    from fgoicp.io import load_cloud
    from fgoicp.models.goicp import GoICP

    src_file = {"090": "bun090.ply", "chin": "chin.ply",
                "045": "bun045.ply"}[args.pair]
    pct = load_cloud(f"{DATA}/bun000.ply", args.tgt_subsample, seed=0)
    pcs = load_cloud(f"{DATA}/{src_file}", args.subsample, seed=1)
    print(f"target bun000: {len(pct)} pts, source {src_file}: "
          f"{len(pcs)} pts, trim={args.trim}, mse={args.mse}",
          flush=True)

    eng = EngineConfig(outer_mode="device" if args.device_outer else "host")
    for i in range(args.runs):
        model = GoICP(pct, pcs, engine=eng, mse_threshold=args.mse,
                      trim_fraction=args.trim)
        t0 = time.time()
        R, t = model.run()
        wall = time.time() - t0
        ang, axis = axis_angle(np.asarray(R))
        print(f"run[{i}] wall={wall:.3f}s mse={model.mse:.4g} "
              f"nodes={model.stats.translation_nodes} "
              f"outer={model.stats.outer_steps} "
              f"icp={model.stats.icp_runs}", flush=True)
        print(f"  angle={ang:.2f} deg axis=({axis[0]:+.3f}, {axis[1]:+.3f},"
              f" {axis[2]:+.3f}) t={np.asarray(t).round(4).tolist()}",
              flush=True)


if __name__ == "__main__":
    main()
