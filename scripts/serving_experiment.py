"""Serving-mode experiments on real data (round 5).

Drives models/serving.py end-to-end on the real skull cloud:
  1. ragged batch — sources of DIFFERENT sizes in one call
  2. fallback-heavy regime — partial-overlap half-space scans at random
     poses, where multi-start seeding cannot always certify and the
     batched-seeding -> BnB-handoff path does real work

    python scripts/serving_experiment.py [--pairs 16] [--mode ragged|fallback]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, ".")

SKULL = "/root/reference/data/artec3d/data_skull.ply"


def make_partial_scans(cloud, b, ns, rng, span):
    """Half-space partial views at random poses: keep points on one side
    of a random plane through the centroid (what a single-view scanner
    sees), subsample, then apply a random SE(3)."""
    sources, Rs, ts = [], [], []
    mu = cloud.mean(axis=0)
    for i in range(b):
        n = rng.normal(size=3)
        n /= np.linalg.norm(n)
        side = (cloud - mu) @ n > 0
        part = cloud[side]
        idx = rng.choice(len(part), size=min(ns, len(part)), replace=False)
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        R = (q * np.sign(np.diag(q))[None, :]).astype(np.float32)
        if np.linalg.det(R) < 0:
            R[:, 0] *= -1
        t = rng.uniform(-0.25, 0.25, size=3).astype(np.float32) * span
        sources.append((part[idx] - t) @ R)
        Rs.append(R)
        ts.append(t)
    return sources, Rs, ts


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=16)
    ap.add_argument("--mode", default="fallback",
                    choices=("ragged", "fallback"))
    ap.add_argument("--trim", type=float, default=0.3)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--seed", type=int, default=11)
    args = ap.parse_args()

    from fgoicp.io import load_cloud
    from fgoicp.models import serving

    cloud = load_cloud(SKULL, 1.0, seed=0)
    rng = np.random.default_rng(args.seed)
    ti = rng.choice(len(cloud), size=6000, replace=False)
    pct = cloud[ti]
    span = float(np.ptp(cloud, axis=0).max())

    if args.mode == "ragged":
        sizes = rng.integers(4000, 9000, size=args.pairs)
        sources, Rs, ts = [], [], []
        for ns in sizes:
            si = rng.choice(len(cloud), size=int(ns), replace=False)
            q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
            R = (q * np.sign(np.diag(q))[None, :]).astype(np.float32)
            if np.linalg.det(R) < 0:
                R[:, 0] *= -1
            t = rng.uniform(-0.25, 0.25, size=3).astype(np.float32) * span
            sources.append((cloud[si] - t) @ R)
            Rs.append(R)
            ts.append(t)
        srv = serving.RegistrationService(pct, mse_threshold=1e-3)
    else:
        sources, Rs, ts = make_partial_scans(
            cloud, args.pairs, 6000, rng, span)
        srv = serving.RegistrationService(pct, mse_threshold=1e-3,
                                          trim_fraction=args.trim)
        sources = np.stack(sources)

    for run in range(args.runs):
        t0 = time.time()
        results = srv.register(sources)
        wall = time.time() - t0
        ok = 0
        for r, R_true, t_true in zip(results, Rs, ts):
            # t tolerance is relative to the CLOUD SPAN, not |t_true|:
            # the subsampled-target NN floor displaces the optimum by a
            # span-relative amount however small the true shift was
            # (bench.py serving_fallback rationale).
            good = (np.abs(r.R - R_true).max() < 5e-3
                    and np.abs(r.t - t_true).max() < 2e-3 * span)
            ok += good
        n_cert = sum(r.certified for r in results)
        n_fb = sum(r.fallback_used for r in results)
        print(f"run[{run}] {args.mode}: {wall:.2f}s for "
              f"{len(results)} pairs ({len(results) / wall:.2f} pairs/s), "
              f"{n_cert} certified, {n_fb} fallbacks, {ok} exact "
              f"recoveries", flush=True)


if __name__ == "__main__":
    main()
