"""Proxy-coreset size sweep: wall / node count per workload (perf aid).

The proxy backend evaluates bounds against P farthest-point target
representatives; P trades per-node kernel cost (linear in P) against
covering-radius slack (more node expansions); the engine default is
P=1024.  Times from this sweep are device measurements: run it on the
GPU.

    python scripts/proxy_sweep.py --workload scan_pair --sizes 4096 1024 512
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")
sys.path.insert(0, "scripts")


def load(name):
    from fgoicp.io import load_cloud
    from profile_phases import load_workload
    data = "/root/reference/data"
    if name in ("bunny", "scan_pair", "dragon"):
        return load_workload(name)
    cloud = load_cloud(f"{data}/artec3d/data_skull.ply", 1.0, seed=0)
    rng = np.random.default_rng(5)
    if name == "skull":      # bench.py skull_known_transform_* pair
        nt, ns, angle = 6000, 8000, 1.8
    elif name == "skull98k":  # bench.py skull_full_resolution_98k
        rng = np.random.default_rng(9)
        nt, ns, angle = len(cloud), 10000, 1.8
    else:
        raise SystemExit(f"unknown workload {name!r}")
    ti = rng.choice(len(cloud), size=nt, replace=False)
    si = rng.choice(len(cloud), size=ns, replace=False)
    c, s = np.cos(angle), np.sin(angle)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    span = float(np.ptp(cloud, axis=0).max())
    t = np.array([0.11, -0.07, 0.05], np.float32) * span
    return cloud[ti], (cloud[si] - t) @ R, 1e-3, 0.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="scan_pair",
                    choices=("bunny", "scan_pair", "dragon", "skull",
                             "skull98k"))
    ap.add_argument("--sizes", type=int, nargs="+",
                    default=[4096, 2048, 1024, 512])
    ap.add_argument("--source-coreset", type=int, default=-1)
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args()

    from fgoicp.config import EngineConfig
    from fgoicp.models.goicp import GoICP

    pct, pcs, mse, trim = load(args.workload)
    for p in args.sizes:
        eng = EngineConfig(icp_multi_start=False,
                           source_coreset=args.source_coreset)
        wall = None
        for _ in range(args.runs):
            model = GoICP(pct, pcs, mse_threshold=mse, engine=eng,
                          proxy_size=p, trim_fraction=trim)
            t0 = time.time()
            model.run()
            wall = time.time() - t0
        print(json.dumps({
            "workload": args.workload, "proxy": p,
            "wall_s": round(wall, 3), "mse": float(model.mse),
            "nodes": model.stats.translation_nodes,
            "steps": model.stats.inner_loop_steps}), flush=True)


if __name__ == "__main__":
    main()
