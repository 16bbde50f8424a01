"""Check every Pallas kernel against its plain XLA reference at real widths.

Runs the kernels as compiled for the GPU (never in interpret mode) on
seeded synthetic clouds and compares each with the plain XLA path
(ops/nn.xla_nearest).  Both sides are float32 with no TF32: both compute
direct squared differences, the kernels on the CUDA cores in registers,
the reference as fused XLA reductions.

    python scripts/kernel_check.py      # exits 1 on any mismatch

Tolerances: lb/ub rtol 2e-4, atol 2e-5 (f32 sums of 2k-10k terms taken
in another order); NN d2 rtol 1e-6; NN argmin identical except at ties,
where the two winners' exact d2 agree to 1e-6.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

BOUND_SHAPES = ((1024, 2048), (1024, 3037), (1024, 10000), (4096, 3037))
NN_SHAPES = ((16 * 2048, 17953), (10000, 98359), (733, 517))
LANES = 1024


def _lane_reference(base, gids, t_lanes, proxies, gam_ub, gam_lb, gam_t,
                    slack, w):
    """Plain XLA lane bounds: q -> NN distance -> radii -> weighted sums."""
    import jax.numpy as jnp

    from fgoicp.ops import nn as nn_ops
    q = base[gids] + t_lanes[:, None, :]                     # [L, ns, 3]
    d2 = nn_ops.xla_nearest(q.reshape(-1, 3), proxies)
    d = jnp.sqrt(jnp.maximum(d2, 0.0)).reshape(q.shape[:2])
    ub = jnp.sum(w * jnp.square(jnp.maximum(d - gam_ub[gids], 0.0)), -1)
    lb = jnp.sum(w * jnp.square(jnp.maximum(
        d - slack - gam_lb[gids] - gam_t[:, None], 0.0)), -1)
    return lb, ub


def _memory_line(name, fn, *args):
    import jax
    ma = jax.jit(fn).lower(*args).compile().memory_analysis()
    if ma is None:
        return f"{name}: memory_analysis unavailable"
    return (f"{name}: args {ma.argument_size_in_bytes} B, out "
            f"{ma.output_size_in_bytes} B, temp {ma.temp_size_in_bytes} B, "
            f"code {ma.generated_code_size_in_bytes} B")


def run_check(seed: int = 0, memory: bool = False):
    """Kernel-vs-reference equality on the default device.

    Returns (ok, lines).  With memory=True, one compiled.memory_analysis()
    line per kernel is added."""
    import jax
    import jax.numpy as jnp

    from fgoicp.io import synthetic
    from fgoicp.ops import bounds as bounds_ops
    from fgoicp.ops import coreset
    from fgoicp.ops import geometry as geo
    from fgoicp.ops import nn as nn_ops
    from fgoicp.ops import pallas_bounds, pallas_nn

    rng = np.random.default_rng(seed)
    cloud = synthetic.bumpy_surface(120000, seed=seed)
    norm = geo.Normalization(cloud[:17953], cloud[-10000:])
    tgt, src_all = norm.pct, norm.pcs
    lines, failures = [], 0

    def record(ok, msg):
        nonlocal failures
        failures += not ok
        lines.append(f"{msg} {'OK' if ok else 'MISMATCH'}")

    for psize, ns in BOUND_SHAPES:
        proxies = coreset.build(tgt, size=psize, seed=seed).points
        slack = jnp.float32(0.01)
        pts = src_all[:ns]
        # Weighted cluster radii on half the shapes, plain points on the
        # other half (the two gam_lb/gam_ub forms the engine produces).
        w = d = None
        if ns == 3037:
            cl = coreset.build_weighted(src_all, size=ns, seed=2)
            pts, w, d = cl.reps, cl.weights, cl.deltas
        g = 8
        R = geo.quat_cube_to_matrix(jnp.asarray(
            rng.uniform(-0.5, 0.5, size=(g, 3)), jnp.float32))
        spans = jnp.full((g,), 0.125, jnp.float32)
        fix = jnp.asarray([True, False] * (g // 2))
        base = jnp.einsum("grc,nc->gnr", R, pts,
                          precision=jax.lax.Precision.HIGHEST)
        norms = jnp.linalg.norm(pts, axis=-1)
        gam_ub, gam_lb = bounds_ops.gamma_arrays(norms, spans, fix,
                                                 point_deltas=d)
        gids = jnp.asarray(rng.integers(0, g, size=(LANES,)), jnp.int32)
        t_lanes = jnp.asarray(rng.uniform(-0.3, 0.3, size=(LANES, 3)),
                              jnp.float32)
        gam_t = geo.translation_uncertainty_radius(jnp.asarray(
            rng.uniform(0.01, 0.2, size=(LANES,)), jnp.float32))
        args = (base, gids, t_lanes, proxies, gam_ub, gam_t, slack, w)
        lb_k, ub_k = pallas_bounds.fused_bounds_lanes(*args, gam_lb=gam_lb)
        lb_x, ub_x = _lane_reference(
            base, gids, t_lanes, proxies, gam_ub, gam_lb, gam_t, slack,
            jnp.ones((pts.shape[0],), jnp.float32) if w is None else w)
        ok = (np.allclose(lb_k, lb_x, rtol=2e-4, atol=2e-5)
              and np.allclose(ub_k, ub_x, rtol=2e-4, atol=2e-5))
        record(ok, f"fused_bounds_lanes L={LANES} ns={pts.shape[0]} "
                   f"P={psize}: max|dlb|={float(jnp.max(jnp.abs(lb_k - lb_x))):.3g} "
                   f"max|dub|={float(jnp.max(jnp.abs(ub_k - ub_x))):.3g} "
                   f"max ub={float(jnp.max(ub_x)):.4g}")
        if memory and (psize, ns) == BOUND_SHAPES[0]:
            lines.append(_memory_line(
                "fused_bounds_lanes",
                lambda *a: pallas_bounds.fused_bounds_lanes(*a,
                                                            gam_lb=gam_lb),
                *args))

    # The grouped [G, B] path (evaluate_bounds flattens it into lanes).
    proxies = coreset.build(tgt, size=1024, seed=seed).points
    backend = bounds_ops.ProxyBackend(coreset=coreset.ProxyCoreset(
        points=proxies, eps=jnp.float32(0.01)))
    g, b = 16, 64
    R = geo.quat_cube_to_matrix(jnp.asarray(
        rng.uniform(-0.5, 0.5, size=(g, 3)), jnp.float32))
    spans = jnp.full((g,), 0.125, jnp.float32)
    fix = jnp.zeros((g,), bool)
    tc = jnp.asarray(rng.uniform(-0.3, 0.3, size=(g, b, 3)), jnp.float32)
    ts = jnp.full((g, b), 0.05, jnp.float32)
    pts = src_all[:3037]
    lb_k, ub_k = bounds_ops.evaluate_bounds(backend, pts, R, spans, fix,
                                            tc, ts)
    base = jnp.einsum("grc,nc->gnr", R, pts,
                      precision=jax.lax.Precision.HIGHEST)
    gam_ub, gam_lb = bounds_ops.gamma_arrays(
        jnp.linalg.norm(pts, axis=-1), spans, fix)
    lb_x, ub_x = _lane_reference(
        base, jnp.repeat(jnp.arange(g, dtype=jnp.int32), b),
        tc.reshape(-1, 3), proxies, gam_ub, gam_lb,
        geo.translation_uncertainty_radius(ts).reshape(-1),
        jnp.float32(0.01), jnp.ones((pts.shape[0],), jnp.float32))
    ok = (np.allclose(lb_k.reshape(-1), lb_x, rtol=2e-4, atol=2e-5)
          and np.allclose(ub_k.reshape(-1), ub_x, rtol=2e-4, atol=2e-5))
    record(ok, f"evaluate_bounds [G={g}, B={b}] ns=3037 P=1024")

    for m, n in NN_SHAPES:
        q = jnp.asarray(rng.uniform(-1.2, 1.2, size=(m, 3)), jnp.float32)
        pts = (tgt if n == tgt.shape[0] else jnp.asarray(
            synthetic.bumpy_surface(n, seed=seed + 1)))
        d_ref, i_ref = nn_ops.xla_nearest(q, pts, want_idx=True)
        d_min = pallas_nn.nn_min(q, pts)
        d_arg, i_arg = pallas_nn.nn_argmin(q, pts)
        d_win = jnp.sum((q - pts[i_arg]) ** 2, axis=-1)
        ties = (i_arg != i_ref)
        tie_ok = bool(jnp.all(jnp.where(
            ties, jnp.abs(d_win - d_ref) <= 1e-6 * jnp.maximum(d_ref, 1e-30),
            True)))
        ok = (np.allclose(d_min, d_ref, rtol=1e-6, atol=0.0)
              and np.allclose(d_arg, d_ref, rtol=1e-6, atol=0.0)
              and tie_ok)
        record(ok, f"nn_min/nn_argmin M={m} N={n}: max|dd2| "
                   f"{float(jnp.max(jnp.abs(d_arg - d_ref))):.3g}, "
                   f"{int(jnp.sum(ties))} argmin ties")
        if memory and (m, n) == NN_SHAPES[0]:
            lines.append(_memory_line("nn_argmin", pallas_nn.nn_argmin,
                                      q, pts))
            lines.append(_memory_line("nn_min", pallas_nn.nn_min, q, pts))
    return failures == 0, lines


def main():
    import jax
    if jax.devices()[0].platform != "gpu":
        print("kernel_check: no GPU found", file=sys.stderr)
        sys.exit(1)
    ok, lines = run_check(memory=True)
    for ln in lines:
        print(ln, flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
