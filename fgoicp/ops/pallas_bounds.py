"""Fused Pallas kernel (Triton route) for batched SE(3) bound evaluation.

Replaces the XLA composition in ops/bounds.py (rotate -> add translation
-> NN distance -> uncertainty radii -> relu^2 -> sum) for the proxy/exact
backends.  The XLA form materializes the [L, ns, 3] query tensor and its
[L * ns, P] distance matrix in device memory; here every lane (one
(group, translation) node) is one program and nothing but its two sums
leaves registers:

  program l (group g = gids[l], translation t = t_lanes[l]):
    for each source tile n (fori_loop):               NT points
        q = base[g, :, n-tile] + t                    [NT] x 3
        m = min over proxy tiles p of d2_tile(p, q)   [PT, NT] -> [NT]
        d = sqrt(m)
        ub += w * relu(d - gam_ub)^2
        lb += w * relu(d - slack - gam_lb - gam_t)^2
    lb[l], ub[l] = sum(lb), sum(ub)

No program writes another's output and there are no atomics, so the sums
are deterministic.  d2 comes from direct squared differences in float32
(pallas_nn.d2_tile): the tensor cores' TF32 rounding of the queries
would break lb <= SSE.  Source tails read weight 0; proxy tails read
+inf and never win the min.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .pallas_nn import d2_tile, load_xyz, soa

# Tuned on an H100 (scripts/kernel_bench.py --tune, L=1024, ns=3037,
# P=1024): 64 x 128 tiles on 4 warps; stages 1-3 made no difference.
NT = 64        # source points per tile
PT = 128       # proxy points per inner tile
NUM_WARPS = 4
NUM_STAGES = 2


def _lane_kernel(ns, p, nt, pt):
    def kernel(gid_ref, tx_ref, ty_ref, tz_ref, gt_ref, slack_ref,
               base_ref, prox_ref, gub_ref, glb_ref, w_ref, lb_ref, ub_ref):
        g = gid_ref[...]
        tx, ty, tz = tx_ref[...], ty_ref[...], tz_ref[...]
        lb_shift = slack_ref[...] + gt_ref[...]

        def src_body(i, acc):
            lb_acc, ub_acc = acc
            cols = i * nt + jnp.arange(nt)
            ok = cols < ns
            bx, by, bz = load_xyz(base_ref, ns, g * 3 * ns, cols, ok)
            qx, qy, qz = bx + tx, by + ty, bz + tz

            def prox_body(j, m):
                d2 = d2_tile(prox_ref, p, j, pt, qx, qy, qz)
                return jnp.minimum(m, jnp.min(d2, axis=0))

            m = jax.lax.fori_loop(0, pl.cdiv(p, pt), prox_body,
                                  jnp.full((nt,), jnp.inf, jnp.float32))
            d = jnp.sqrt(jnp.maximum(m, 0.0))
            w = plgpu.load(w_ref.at[cols], mask=ok, other=0.0)
            gub = plgpu.load(gub_ref.at[g * ns + cols], mask=ok, other=0.0)
            glb = plgpu.load(glb_ref.at[g * ns + cols], mask=ok, other=0.0)
            ub_t = jnp.square(jnp.maximum(d - gub, 0.0))
            lb_t = jnp.square(jnp.maximum(d - lb_shift - glb, 0.0))
            return (lb_acc + jnp.where(ok, w * lb_t, 0.0),
                    ub_acc + jnp.where(ok, w * ub_t, 0.0))

        zeros = jnp.zeros((nt,), jnp.float32)
        lb_acc, ub_acc = jax.lax.fori_loop(0, pl.cdiv(ns, nt), src_body,
                                           (zeros, zeros))
        lb_ref[...] = jnp.sum(lb_acc)
        ub_ref[...] = jnp.sum(ub_acc)

    return kernel


@functools.partial(jax.jit, static_argnames=("interpret",))
def fused_bounds_lanes(base, gids, t_lanes, proxies, gam_ub, gam_t_lanes,
                       slack, point_weights=None, interpret: bool = False,
                       gam_lb=None):
    """lb, ub [L] for L independent lanes (the pooled-frontier hot op).

    base:        [G, ns, 3] rotated source per group (R_g @ p).
    gids:        [L] int32 group id per lane (selects base/gam rows).
    t_lanes:     [L, 3] translation per lane.
    proxies:     [P, 3] target proxy points.
    gam_ub/gam_lb: [G, ns] per-point radii for the upper/lower bound terms
                 (pre-zeroed rows for fixed-rotation groups; gam_lb
                 defaults to gam_ub; they differ for weighted source
                 coresets).
    gam_t_lanes: [L] translation uncertainty per lane.
    slack:       scalar distance slack for the lower bound.
    point_weights: [ns] (0 marks padding, cluster multiplicity otherwise).

    Tiles and warps are the module constants, read at trace time (a
    tuning script sets them before tracing a fresh jit of `.__wrapped__`).
    """
    if gam_lb is None:
        gam_lb = gam_ub
    g, ns, _ = base.shape
    lanes = gids.shape[0]
    p = proxies.shape[0]
    w = (jnp.ones((ns,), jnp.float32) if point_weights is None
         else jnp.asarray(point_weights, jnp.float32))
    t_lanes = jnp.asarray(t_lanes, jnp.float32)
    base_soa = jnp.swapaxes(jnp.asarray(base, jnp.float32), 1, 2)  # [G,3,ns]

    lane = pl.BlockSpec((None,), lambda l: (l,))
    shared = pl.BlockSpec((None,), lambda l: (0,))
    whole = pl.BlockSpec()
    lb, ub = pl.pallas_call(
        _lane_kernel(ns, p, NT, PT),
        grid=(lanes,),
        in_specs=[lane] * 5 + [shared] + [whole] * 5,
        out_specs=[lane, lane],
        out_shape=[jax.ShapeDtypeStruct((lanes,), jnp.float32)] * 2,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name="fused_bounds_lanes",
    )(jnp.asarray(gids, jnp.int32),
      t_lanes[:, 0], t_lanes[:, 1], t_lanes[:, 2],
      jnp.asarray(gam_t_lanes, jnp.float32).reshape(lanes),
      jnp.asarray(slack, jnp.float32).reshape(1),
      base_soa.reshape(-1), soa(proxies),
      jnp.asarray(gam_ub, jnp.float32).reshape(-1),
      jnp.asarray(gam_lb, jnp.float32).reshape(-1), w)
    return lb, ub
