#!/usr/bin/env python
"""Generate a registration test pair: subsample a cloud, apply a random
known rigid transform, and save both the transformed cloud and the
ground-truth (R, t).

Capability parity with the reference's offline tool
(/root/reference/scripts/transform_point_cloud.py:1-88): load a PLY (or
TXT), sample a fraction of points with a normal-distribution index bias,
apply a random rotation (Euler zyx) and a random translation, and write
the result — but seeded/deterministic, with the ground truth emitted as
TOML so tests can assert recovery.

Usage:
    python scripts/make_test_pair.py in.ply out.ply \
        [--fraction 0.1] [--t-range 5.0] [--seed 0] [--truth truth.toml]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from fgoicp.io import load_cloud, write_ply  # noqa: E402


def biased_subsample(points: np.ndarray, fraction: float,
                     rng: np.random.Generator) -> np.ndarray:
    """Sample ~fraction of points with normal-distribution index bias
    (reference scripts/transform_point_cloud.py:15-30: indices drawn from
    N(n/2, n/6), clipped, deduplicated)."""
    n = len(points)
    k = max(1, int(n * fraction))
    idx = rng.normal(loc=n / 2.0, scale=n / 6.0, size=4 * k)
    idx = np.clip(idx, 0, n - 1).astype(np.int64)
    idx = np.unique(idx)[:k]
    return points[idx]


def random_rotation_zyx(rng: np.random.Generator) -> np.ndarray:
    """Random Euler-zyx rotation (reference :40-54)."""
    a, b, c = rng.uniform(0.0, 2.0 * np.pi, size=3)
    cz, sz = np.cos(a), np.sin(a)
    cy, sy = np.cos(b), np.sin(b)
    cx, sx = np.cos(c), np.sin(c)
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    return (rz @ ry @ rx).astype(np.float64)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--fraction", type=float, default=0.1)
    p.add_argument("--t-range", type=float, default=5.0,
                   help="translation sampled uniformly from [-r, r]^3 "
                        "(reference :82 uses 5.0)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--truth", default="",
                   help="write ground-truth R, t as TOML here")
    args = p.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    pts = load_cloud(args.input).astype(np.float64)
    sub = biased_subsample(pts, args.fraction, rng)
    R = random_rotation_zyx(rng)
    t = rng.uniform(-args.t_range, args.t_range, size=3)
    out = sub @ R.T + t
    write_ply(args.output, out.astype(np.float32))
    print(f"wrote {len(out)} pts -> {args.output}")

    if args.truth:
        rows = ",\n  ".join(
            "[" + ", ".join(f"{v:.17g}" for v in row) + "]" for row in R)
        with open(args.truth, "w") as f:
            f.write(f"[truth]\nseed = {args.seed}\n"
                    f"translation = [{', '.join(f'{v:.17g}' for v in t)}]\n"
                    f"rotation = [\n  {rows},\n]\n")
        print(f"wrote ground truth -> {args.truth}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
