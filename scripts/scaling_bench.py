#!/usr/bin/env python
"""Cubes-evaluated/s scaling harness.

Runs the pooled-sharded inner BnB over growing cube-axis meshes on a
fixed synthetic workload and reports nodes/s and scaling efficiency.
Run on several GPUs for meaningful numbers:

    python scripts/scaling_bench.py                 # all local devices
    python scripts/scaling_bench.py --max-devices 4

On a CPU host with virtual devices (XLA_FLAGS=
--xla_force_host_platform_device_count=8) this validates the collective
code path, but the "devices" share physical cores, so efficiency numbers
are NOT representative — the harness prints a warning.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--max-devices", type=int, default=0,
                   help="limit the device count (0 = all)")
    p.add_argument("--groups", type=int, default=64,
                   help="rotation groups in the workload")
    p.add_argument("--ns", type=int, default=2048, help="source points")
    p.add_argument("--nt", type=int, default=8192, help="target points")
    p.add_argument("--lanes", type=int, default=512,
                   help="pool lanes per shard")
    p.add_argument("--proxy", type=int, default=4096, help="proxy points")
    p.add_argument("--max-steps", type=int, default=400)
    p.add_argument("--device-outer", action="store_true",
                   help="scale the WHOLE nested BnB (so3_bnb_device_"
                        "sharded, cube-axis sliced child evaluation) "
                        "instead of the inner pooled search")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np
    from fgoicp.ops import bounds as bounds_ops
    from fgoicp.ops import geometry as geo
    from fgoicp.parallel import bnb as pbnb
    from fgoicp.parallel import sharding as psh

    devices = jax.devices()
    n_avail = len(devices)
    if args.max_devices:
        n_avail = min(n_avail, args.max_devices)
    if jax.default_backend() == "cpu":
        print("WARNING: CPU backend — virtual devices share physical "
              "cores; efficiency numbers are functional-validation only.",
              file=sys.stderr)

    rng = np.random.default_rng(0)
    pct = jnp.asarray(rng.uniform(-0.9, 0.9, (args.nt, 3)), jnp.float32)
    pcs = jnp.asarray(rng.uniform(-0.7, 0.7, (args.ns, 3)), jnp.float32)
    backend = bounds_ops.make_backend(pct, kind="proxy",
                                      proxy_size=args.proxy)
    g = args.groups
    xyz = jnp.asarray(rng.uniform(-0.5, 0.5, (g, 3)), jnp.float32)
    R = geo.quat_cube_to_matrix(xyz)
    spans = jnp.full((g,), 0.25, jnp.float32)
    fix = jnp.asarray([True, False] * (g // 2))

    counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_avail]
    base_rate = None
    print(f"{'devices':>8} {'nodes':>10} {'wall_s':>8} {'nodes/s':>12} "
          f"{'efficiency':>10}")
    for n in counts:
        mesh = psh.make_mesh(n, 1, devices=devices[:n])

        if args.device_outer:
            # Whole nested BnB, SO(3) frontier replicated, child
            # evaluation + ICP lanes sliced over the cubes axis
            # (ops/so3_frontier.py module doc).  Each shard pops
            # rotation_batch cubes per step, so the n-device run
            # explores an (n x rotation_batch)-wide outer octree.
            # Coarse span cutoffs bound the tree (the un-pruned 1e9
            # incumbent would otherwise let every inner pool subdivide
            # to the default production depth — hours on a CPU host).
            def run():
                st = pbnb.so3_bnb_device_sharded(
                    backend, pct, pcs, pcs, jnp.float32(1e9),
                    jnp.eye(3, dtype=jnp.float32),
                    jnp.zeros(3, jnp.float32), jnp.float32(1e-3),
                    mesh=mesh, rotation_batch=max(2, g // (8 * n)),
                    capacity=8192, max_outer=args.max_steps // 10 or 1,
                    rotation_min_span=0.2, translation_min_span=0.25,
                    pool_lanes=args.lanes, pool_capacity=args.lanes * 16,
                    icp_width=8, icp_max_iter=10)
                jax.block_until_ready(st)
                return int(np.asarray(st.inner_nodes))
        else:
            def run():
                st = pbnb.bnb_r3_pooled_sharded(
                    backend, pcs, R, spans, fix, jnp.float32(1e9),
                    jnp.float32(1e-3), mesh=mesh, lanes=args.lanes,
                    capacity=args.lanes * 16, max_steps=args.max_steps)
                jax.block_until_ready(st)
                return int(np.asarray(st.evaluated).sum())

        run()                      # compile + first-call load
        t0 = time.time()
        nodes = run()
        wall = time.time() - t0
        rate = nodes / wall
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * n)
        print(f"{n:>8} {nodes:>10} {wall:>8.2f} {rate:>12.0f} {eff:>9.1%}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
