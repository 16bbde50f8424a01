"""Time each Pallas kernel against the plain XLA forms on the GPU.

Isolated: the pooled bound step (L=1024 lanes, P=1024 proxies, ns =
2048 / 3037 / 10000) and NN (16x2048 queries vs 17,953 points, 10,000 vs
98,359), each as the kernel, as the direct-difference XLA form the
package uses off the GPU (ops/nn._direct_min) and as the norm-expansion
XLA form (a K=3 matrix product + min, `gemm_min` below, the form the
package had before).  End to end: the search-only registration of
a seeded bunny-scale pair (17,953-pt target, 3,037-pt source) with both
kernels, with each kernel alone, and with each XLA form, in turns.
--tune sweeps the kernels' tile sizes and warp counts first.

    python scripts/kernel_bench.py [--tune] [--e2e-rounds 2]

Prints one JSON object per measurement; seconds are medians of host
clock around work that ends in block_until_ready.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def emit(**kw):
    print(json.dumps(kw), flush=True)


def timeit(fn, *args, calls=10, reps=5):
    """Median seconds per call (calls enqueued back to back, then one
    block_until_ready), after one warm-up call that compiles."""
    import jax
    jax.block_until_ready(fn(*args))
    per = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = None
        for _ in range(calls):
            out = fn(*args)
        jax.block_until_ready(out)
        per.append((time.perf_counter() - t0) / calls)
    return statistics.median(per)


def lane_problem(ns, p, lanes=1024, g=16, seed=0):
    import jax
    import jax.numpy as jnp

    from fgoicp.io import synthetic
    from fgoicp.ops import bounds as bounds_ops
    from fgoicp.ops import coreset
    from fgoicp.ops import geometry as geo
    rng = np.random.default_rng(seed)
    cloud = synthetic.bumpy_surface(40000, seed=seed)
    norm = geo.Normalization(cloud[:17953], cloud[-ns:])
    proxies = coreset.build(norm.pct, size=p, seed=seed).points
    R = geo.quat_cube_to_matrix(jnp.asarray(
        rng.uniform(-0.5, 0.5, size=(g, 3)), jnp.float32))
    spans = jnp.full((g,), 0.125, jnp.float32)
    base = jnp.einsum("grc,nc->gnr", R, norm.pcs,
                      precision=jax.lax.Precision.HIGHEST)
    gam_ub, gam_lb = bounds_ops.gamma_arrays(
        jnp.linalg.norm(norm.pcs, axis=-1), spans, jnp.zeros((g,), bool))
    gids = jnp.asarray(rng.integers(0, g, size=(lanes,)), jnp.int32)
    t_lanes = jnp.asarray(rng.uniform(-0.3, 0.3, size=(lanes, 3)),
                          jnp.float32)
    gam_t = geo.translation_uncertainty_radius(jnp.full((lanes,), 0.05))
    return (base, gids, t_lanes, proxies, gam_ub, gam_t, jnp.float32(0.01),
            None, gam_lb)


def gemm_min(queries, pct, t_chunk, want_idx):
    """Norm-expansion chunk reduction: ||q||^2 + ||p||^2 - 2 q.p with the
    cross term a K=3 matrix product at precision HIGHEST, then an exact
    rescore of the winner.  Same contract as ops/nn._direct_min."""
    import jax
    import jax.numpy as jnp
    m = queries.shape[0]
    chunks = pct.reshape(-1, t_chunk, 3)
    q_sq = jnp.sum(queries * queries, axis=-1)

    def body(carry, p):
        best, arg, i = carry
        cross = jnp.dot(queries, p.T, precision=jax.lax.Precision.HIGHEST)
        d2 = q_sq[:, None] + jnp.sum(p * p, -1)[None, :] - 2.0 * cross
        lm = jnp.min(d2, axis=-1)
        upd = lm < best
        return (jnp.where(upd, lm, best),
                jnp.where(upd, jnp.argmin(d2, -1) + i * t_chunk, arg),
                i + 1), None

    init = (jnp.full((m,), 1e10, jnp.float32), jnp.zeros((m,), jnp.int32),
            jnp.int32(0))
    (_, idx, _), _ = jax.lax.scan(body, init, chunks)
    d2 = jnp.sum((queries - pct[idx]) ** 2, axis=-1)
    return (d2, idx) if want_idx else d2


def traced_with(mod, attrs, fn):
    """A fresh jit of fn, traced with module attributes `attrs` set on
    `mod` (the kernels read their tiles, and ops/nn its chunk reduction,
    at trace time)."""
    import jax

    def traced(*args):
        saved = {k: getattr(mod, k) for k in attrs}
        for k, v in attrs.items():
            setattr(mod, k, v)
        try:
            return fn(*args)
        finally:
            for k, v in saved.items():
                setattr(mod, k, v)
    return jax.jit(traced)


def with_form(form, fn):
    """fn with the XLA NN chunk reduction pinned to `form`."""
    from fgoicp.ops import nn as nn_ops
    return traced_with(nn_ops, {"_direct_min": form}, fn)


def xla_lanes(base, gids, t_lanes, proxies, gam_ub, gam_t, slack, w,
              gam_lb):
    """The XLA lane step (pool_frontier._eval_lanes_xla's untrimmed
    arithmetic) on the plain XLA NN path."""
    import jax.numpy as jnp

    from fgoicp.ops import nn as nn_ops
    q = base[gids] + t_lanes[:, None, :]
    d2 = nn_ops.xla_nearest_impl(q.reshape(-1, 3), proxies)
    d = jnp.sqrt(jnp.maximum(d2, 0.0)).reshape(q.shape[:2])
    ub = jnp.sum(jnp.square(jnp.maximum(d - gam_ub[gids], 0.0)), -1)
    lb = jnp.sum(jnp.square(jnp.maximum(
        d - slack - gam_lb[gids] - gam_t[:, None], 0.0)), -1)
    return lb, ub


def kernel_lanes(**tiles):
    """The lane kernel with tile constants `tiles` (nt, pt, num_warps,
    num_stages)."""
    from fgoicp.ops import pallas_bounds
    return traced_with(
        pallas_bounds, {k.upper(): v for k, v in tiles.items()},
        lambda *a: pallas_bounds.fused_bounds_lanes.__wrapped__(
            *a[:8], gam_lb=a[8]))


def kernel_nn(want_idx, **tiles):
    """The NN kernel with tile constants `tiles` (qt, tt, num_warps,
    num_stages)."""
    from fgoicp.ops import pallas_nn
    return traced_with(
        pallas_nn, {k.upper(): v for k, v in tiles.items()},
        functools.partial(pallas_nn.nn_call, want_idx=want_idx))


def nn_problem(m, n, seed=0):
    import jax.numpy as jnp

    from fgoicp.io import synthetic
    rng = np.random.default_rng(seed)
    pts = jnp.asarray(synthetic.bumpy_surface(n, seed=seed + 1))
    q = jnp.asarray(rng.uniform(-1.2, 1.2, size=(m, 3)), jnp.float32)
    return q, pts


def isolated(tiles_b, tiles_n):
    from fgoicp.ops import nn as nn_ops
    forms = {"xla_direct": nn_ops._direct_min, "xla_gemm": gemm_min}
    for ns in (2048, 3037, 10000):
        args = lane_problem(ns, 1024)
        row = {"kernel": timeit(kernel_lanes(**tiles_b), *args)}
        for name, form in forms.items():
            row[name] = timeit(with_form(form, xla_lanes), *args, calls=2,
                               reps=3)
        emit(what="bound_step", lanes=1024, ns=ns, P=1024, seconds=row)
    for m, n in ((16 * 2048, 17953), (10000, 98359)):
        q, pts = nn_problem(m, n)
        for want in (True, False):
            row = {"kernel": timeit(kernel_nn(want, **tiles_n), q, pts)}
            for name, form in forms.items():
                x = with_form(form, functools.partial(
                    nn_ops.xla_nearest_impl, want_idx=want))
                row[name] = timeit(x, q, pts, calls=2, reps=3)
            emit(what="nn_argmin" if want else "nn_min", M=m, N=n,
                 seconds=row)


def tune():
    """Sweep tile sizes / warps; returns the fastest settings."""
    args = lane_problem(3037, 1024)
    best_b = None
    grid = [dict(nt=nt, pt=pt, num_warps=nw) for nt in (32, 64, 128)
            for pt in (32, 64, 128) for nw in (4, 8)]
    for tiles in grid + ["stages1", "stages3"]:
        if isinstance(tiles, str):   # pipeline stages on the best tiles
            tiles = dict(best_b[1], num_stages=int(tiles[-1]))
        try:
            s = timeit(kernel_lanes(**tiles), *args, calls=3, reps=3)
        except Exception as e:  # a refused config is a data point
            emit(what="tune_bounds", tiles=tiles, error=repr(e)[:200])
            continue
        emit(what="tune_bounds", tiles=tiles, seconds=s)
        if best_b is None or s < best_b[0]:
            best_b = (s, tiles)
    probs = [nn_problem(16 * 2048, 17953), nn_problem(10000, 98359)]
    best_n = None
    grid = [dict(qt=qt, tt=tt, num_warps=nw) for qt in (32, 64, 128)
            for tt in (32, 64, 128) for nw in (4, 8)]
    for tiles in grid + ["stages1", "stages3"]:
        if isinstance(tiles, str):
            tiles = dict(best_n[1], num_stages=int(tiles[-1]))
        k = kernel_nn(True, **tiles)
        try:
            s = sum(timeit(k, q, pts, calls=3, reps=3) for q, pts in probs)
        except Exception as e:
            emit(what="tune_nn", tiles=tiles, error=repr(e)[:200])
            continue
        emit(what="tune_nn", tiles=tiles, seconds_sum_of_2=s)
        if best_n is None or s < best_n[0]:
            best_n = (s, tiles)
    emit(what="tune_best", bounds=best_b, nn=best_n)
    return best_b[1], best_n[1]


def end_to_end(rounds):
    """Search-only bunny-scale registration per variant, in turns."""
    import jax

    from fgoicp.config import EngineConfig
    from fgoicp.io import synthetic
    from fgoicp.models.goicp import GoICP
    from fgoicp.ops import bounds as bounds_ops
    from fgoicp.ops import nn as nn_ops

    cloud = synthetic.bumpy_surface(35947, seed=0)
    pct, pcs, R_true, t_true = synthetic.known_pose_pair(
        cloud, 17953, 3037, seed=1, angle=2.0)
    direct, gemm = nn_ops._direct_min, gemm_min
    variants = {            # (NN kernel, bound kernel, XLA NN form)
        "kernels": (True, True, direct),
        "nn_kernel_only": (True, False, direct),
        "bounds_kernel_only": (False, True, direct),
        "xla_direct": (False, False, direct),
        "xla_gemm": (False, False, gemm),
    }
    names = list(variants)
    order = []
    for r in range(rounds):
        order += names if r % 2 == 0 else names[::-1]
    for name in order:
        nn_k, b_k, form = variants[name]
        nn_ops.use_pallas = lambda v=nn_k: v
        bounds_ops._use_fused_kernel = lambda v=b_k: v
        nn_ops._direct_min = form
        jax.clear_caches()
        walls = []
        for _ in range(2):
            model = GoICP(pct, pcs, mse_threshold=1e-3,
                          engine=EngineConfig(icp_multi_start=False))
            t0 = time.perf_counter()
            R, t = model.run()
            walls.append(time.perf_counter() - t0)
        emit(what="e2e_search_only", variant=name, cold_s=walls[0],
             steady_s=walls[1], nodes=model.stats.translation_nodes,
             inner_steps=model.stats.inner_loop_steps,
             outer_steps=model.stats.outer_steps,
             mse=float(model.mse),
             r_err=float(np.abs(np.asarray(R) - R_true).max()))
    nn_ops._direct_min = direct


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tune", action="store_true")
    ap.add_argument("--e2e-rounds", type=int, default=2)
    ap.add_argument("--skip-isolated", action="store_true")
    args = ap.parse_args()
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print("kernel_bench: no GPU found", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    emit(what="device", kind=dev.device_kind, count=len(jax.devices()),
         nvidia_smi=smi.strip().splitlines()[0] if smi.strip() else "")
    tiles_b, tiles_n = {}, {}
    if args.tune:
        tiles_b, tiles_n = tune()
    if not args.skip_isolated:
        isolated(tiles_b, tiles_n)
    if args.e2e_rounds:
        from fgoicp.ops import pallas_bounds, pallas_nn
        for mod, tiles in ((pallas_bounds, tiles_b), (pallas_nn, tiles_n)):
            for k, v in tiles.items():
                setattr(mod, k.upper(), v)
        end_to_end(args.e2e_rounds)


if __name__ == "__main__":
    main()
