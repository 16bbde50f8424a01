"""Exact nearest-neighbour kernels (Pallas, Triton route).

The ICP hot loop queries [G*ns] points against the full target every
iteration (/root/reference/fgoicp/icp3d.cu:11-28 does this brute-force on
CUDA).  The plain XLA form in ops/nn.py turns the distance into a K=3
matrix product and writes every [Q, T] d2 tile to device memory and back:
~8 bytes of traffic per ~9 flops, so it is bound by memory bandwidth.
Here one program owns a block of QT queries and walks the target in
register-resident tiles:

  program (i, s):                   q block [QT] (x, y, z rows)
    for each target tile t of split s (fori_loop):
      d2    = (cx - qx)^2 + (cy - qy)^2 + (cz - qz)^2   [TT, QT]
      m, mi = running (min, argmin)                     [QT]

d2 comes from direct squared differences in float32 on the CUDA cores:
exact, with no norm-expansion cancellation and no TF32 rounding (the
tensor cores would round the coordinates to TF32 and flip argmins; in
the bound kernel such rounding would void lb <= SSE).  Points travel as
structure-of-arrays rows ([3 * N] flat: x row, y row, z row) because
Triton blocks must have power-of-two extents; tails are masked, not
padded.  `d2_tile` is the tile step shared with ops/pallas_bounds.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Tuned on an H100 (scripts/kernel_bench.py --tune, 16x2048 queries vs
# 17,953 points and 10,000 vs 98,359): 128 x 128 tiles on 4 warps.
QT = 128       # queries per program
TT = 128       # target points per inner tile
NUM_WARPS = 4
NUM_STAGES = 1
PROGRAMS = 1024  # programs to aim for: ~8 per SM on a 132-SM H100


def soa(points):
    """[N, 3] -> flat [3 * N] structure-of-arrays rows (x, y, z)."""
    return jnp.asarray(points, jnp.float32).reshape(-1, 3).T.reshape(-1)


def load_xyz(ref, n, base, idx, mask, other=0.0):
    """x, y, z of points idx (masked) from a flat SoA ref whose row for
    one cloud of n points starts at `base`."""
    return tuple(plgpu.load(ref.at[base + c * n + idx], mask=mask,
                            other=other) for c in range(3))


def d2_tile(ref, n, t, tile, qx, qy, qz):
    """Squared distances [tile, Q] from target tile t of the flat SoA
    ref (n points) to queries q*[Q].  Rows past n read +inf, so they
    never win a min."""
    rows = t * tile + jnp.arange(tile)
    cx, cy, cz = load_xyz(ref, n, 0, rows, rows < n, other=jnp.inf)
    dx = cx[:, None] - qx[None, :]
    dy = cy[:, None] - qy[None, :]
    dz = cz[:, None] - qz[None, :]
    return dx * dx + dy * dy + dz * dz


def _nn_kernel(m, n, qt, tt, tiles_per_split, want_idx):
    def kernel(q_ref, tgt_ref, *out_refs):
        cols = pl.program_id(0) * qt + jnp.arange(qt)
        split = pl.program_id(1)
        ok = cols < m
        qx, qy, qz = load_xyz(q_ref, m, 0, cols, ok)

        def body(t, carry):
            best, arg = carry
            d2 = d2_tile(tgt_ref, n, t, tt, qx, qy, qz)
            lm = jnp.min(d2, axis=0)
            upd = lm < best                      # earlier tile wins ties
            best = jnp.where(upd, lm, best)
            if want_idx:
                la = jnp.argmin(d2, axis=0).astype(jnp.int32) + t * tt
                arg = jnp.where(upd, la, arg)
            return best, arg

        init = (jnp.full((qt,), jnp.inf, jnp.float32),
                jnp.zeros((qt,), jnp.int32))
        t0 = split * tiles_per_split
        best, arg = jax.lax.fori_loop(t0, t0 + tiles_per_split, body, init)
        out = split * m + cols
        plgpu.store(out_refs[0].at[out], best, mask=ok)
        if want_idx:
            plgpu.store(out_refs[1].at[out], arg, mask=ok)

    return kernel


def _target_splits(m, n, qt, tt):
    """Programs along the target axis: enough (query block, target
    split) programs to fill the GPU's SMs when the query axis alone
    is short, while every split keeps at least 8 tiles."""
    m_blocks = pl.cdiv(m, qt)
    return max(1, min(pl.cdiv(PROGRAMS, m_blocks), pl.cdiv(n, 16 * tt)))


def nn_call(queries, points, *, want_idx, interpret=False):
    """Unjitted kernel call: d2 [M] (and idx [M] with want_idx).  Tiles
    and warps are the module constants, read at trace time (a tuning
    script sets them before tracing a fresh jit).

    With S target splits each program writes a partial (min, argmin)
    over its contiguous target range; a [S, M] reduction then picks the
    lowest split among equal minima, so ties still go to the lowest
    index."""
    qt, tt = QT, TT
    queries = jnp.asarray(queries, jnp.float32).reshape(-1, 3)
    points = jnp.asarray(points, jnp.float32).reshape(-1, 3)
    m, n = queries.shape[0], points.shape[0]
    splits = _target_splits(m, n, qt, tt)
    tiles_per_split = pl.cdiv(pl.cdiv(n, tt), splits)
    out_shape = [jax.ShapeDtypeStruct((splits * m,), jnp.float32)]
    if want_idx:
        out_shape.append(jax.ShapeDtypeStruct((splits * m,), jnp.int32))
    out = pl.pallas_call(
        _nn_kernel(m, n, qt, tt, tiles_per_split, want_idx),
        grid=(pl.cdiv(m, qt), splits),
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name="nn_argmin" if want_idx else "nn_min",
    )(soa(queries), soa(points))
    d2 = out[0].reshape(splits, m)
    if not want_idx:
        return jnp.min(d2, axis=0)
    win = jnp.argmin(d2, axis=0)
    return (jnp.take_along_axis(d2, win[None], 0)[0],
            jnp.take_along_axis(out[1].reshape(splits, m), win[None], 0)[0])


@functools.partial(jax.jit, static_argnames=("interpret",))
def nn_argmin(queries, points, interpret: bool = False):
    """(d2 [M], idx [M]) of the nearest point for each query; both exact
    in f32, ties resolved to the lowest index like jnp.argmin."""
    return nn_call(queries, points, want_idx=True, interpret=interpret)


@functools.partial(jax.jit, static_argnames=("interpret",))
def nn_min(queries, points, interpret: bool = False):
    """d2 [M] of the nearest point for each query (no argmin
    bookkeeping: bound evaluation needs the distance only)."""
    return nn_call(queries, points, want_idx=False, interpret=interpret)
