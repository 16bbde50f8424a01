"""Exact nearest-neighbor search: streaming direct squared differences.

Replaces the reference's O(ns*nt) brute-force CUDA loops
(/root/reference/fgoicp/registration.cu:162-174, icp3d.cu:11-28).  On the
GPU the Pallas kernels of ops/pallas_nn.py do the work; everywhere else
(and as their reference) the plain XLA path below streams the target in
fixed-size chunks with a running (min, argmin) carry, so memory stays
bounded for any nt, and maps the query axis in chunks so any M works.
Each chunk is one fused elementwise + reduce: d2 = (qx - px)^2 +
(qy - py)^2 + (qz - pz)^2, exact in float32.  (The norm expansion
||q||^2 + ||p||^2 - 2 q.p as a K=3 matrix product cancels near zero,
needs a winner rescore, and measured 2.8-4x slower on the H100 because
it writes every [Q, T] tile to device memory; PERF.md.)

All functions are shape-polymorphic in Python but trace to static shapes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import pallas_nn

BIG = jnp.float32(1e10)  # reference M_INF (common.hpp:18)


def use_pallas() -> bool:
    """The Pallas kernels (Triton route) run on the GPU; every other
    backend takes the plain XLA path."""
    return jax.default_backend() == "gpu"


# Streaming chunk sizes of the XLA path: a [Q, T] chunk is one fused
# reduction.
_T_CHUNK = 2048
_Q_CHUNK = 8192


def _pad_target(pct, t_chunk):
    """Pad target to a multiple of t_chunk with far-away sentinel points
    (their squared distances overflow to +inf and never win)."""
    nt = pct.shape[0]
    pad = (-nt) % t_chunk
    if pad:
        sentinel = jnp.full((pad, 3), 1e18, dtype=pct.dtype)
        pct = jnp.concatenate([pct, sentinel], axis=0)
    return pct, nt


def _direct_min(queries, pct, t_chunk, want_idx):
    """Streaming (min, first argmin) over target chunks.

    queries: [M, 3]; pct: [NT_padded, 3] (padded with sentinels).
    Returns d2[M] (and idx[M] into the padded target if want_idx).
    """
    m = queries.shape[0]
    n_chunks = pct.shape[0] // t_chunk
    pct_chunks = pct.reshape(n_chunks, t_chunk, 3)
    qx, qy, qz = queries[:, 0:1], queries[:, 1:2], queries[:, 2:3]

    def body(carry, chunk):
        best_d2, best_idx, chunk_i = carry
        d2 = ((qx - chunk[None, :, 0]) ** 2 + (qy - chunk[None, :, 1]) ** 2
              + (qz - chunk[None, :, 2]) ** 2)                  # [M, T]
        # One variadic reduce for both (measured ~3x faster on the CPU
        # than a plain min).
        local_min, local_arg = _min_argmin(d2)
        improved = local_min < best_d2           # earlier chunk wins ties
        return (jnp.where(improved, local_min, best_d2),
                jnp.where(improved, local_arg + chunk_i * t_chunk,
                          best_idx), chunk_i + 1), None

    init = (jnp.full((m,), jnp.inf, jnp.float32),
            jnp.zeros((m,), jnp.int32), jnp.int32(0))
    (d2, idx, _), _ = jax.lax.scan(body, init, pct_chunks)
    return (d2, idx) if want_idx else d2


def _min_argmin(d2):
    """(min, first argmin) over the last axis in one variadic reduce."""
    iota = jax.lax.broadcasted_iota(jnp.int32, d2.shape, d2.ndim - 1)

    def pick(a, b):
        (av, ai), (bv, bi) = a, b
        take_b = (bv < av) | ((bv == av) & (bi < ai))
        return jnp.where(take_b, bv, av), jnp.where(take_b, bi, ai)

    return jax.lax.reduce((d2, iota), (jnp.float32(jnp.inf), jnp.int32(0)),
                          pick, (d2.ndim - 1,))


def _q_chunked(fn, queries, q_chunk):
    """Map fn over query chunks to bound the [Q, T] tile size."""
    m = queries.shape[0]
    if m <= q_chunk:
        return fn(queries)
    pad = (-m) % q_chunk
    padded = jnp.concatenate([queries, jnp.zeros((pad, 3), queries.dtype)], axis=0)
    chunks = padded.reshape(-1, q_chunk, 3)
    out = jax.lax.map(fn, chunks)
    out = jax.tree_util.tree_map(lambda a: a.reshape((-1,) + a.shape[2:])[:m], out)
    return out


def xla_nearest_impl(queries, pct, want_idx=False, t_chunk=_T_CHUNK,
                     q_chunk=_Q_CHUNK):
    """Plain XLA nearest-neighbour search (unjitted): d2 [M] (and
    idx [M], ties to the lowest index)."""
    queries = jnp.asarray(queries, jnp.float32).reshape(-1, 3)
    pct_p, _ = _pad_target(jnp.asarray(pct, jnp.float32), t_chunk)
    fn = lambda q: _direct_min(q, pct_p, t_chunk, want_idx=want_idx)
    return _q_chunked(fn, queries, q_chunk)


xla_nearest = jax.jit(xla_nearest_impl, static_argnames=(
    "want_idx", "t_chunk", "q_chunk"))
xla_nearest.__doc__ = """The plain XLA path of nearest_sqdist/nearest_neighbor,
on every backend: the reference the Pallas kernels are checked against."""


@functools.partial(jax.jit, static_argnames=("t_chunk", "q_chunk"))
def nearest_sqdist(queries, pct, t_chunk=_T_CHUNK, q_chunk=_Q_CHUNK):
    """Min squared distance from each query [M, 3] to the target cloud."""
    queries = jnp.asarray(queries, jnp.float32).reshape(-1, 3)
    if use_pallas():
        return pallas_nn.nn_min(queries, jnp.asarray(pct, jnp.float32))
    return xla_nearest(queries, pct, want_idx=False, t_chunk=t_chunk,
                       q_chunk=q_chunk)


@functools.partial(jax.jit, static_argnames=("t_chunk", "q_chunk"))
def nearest_neighbor(queries, pct, t_chunk=_T_CHUNK, q_chunk=_Q_CHUNK):
    """(min squared distance, argmin index) per query."""
    queries = jnp.asarray(queries, jnp.float32).reshape(-1, 3)
    if use_pallas():
        return pallas_nn.nn_argmin(queries, jnp.asarray(pct, jnp.float32))
    return xla_nearest(queries, pct, want_idx=True, t_chunk=t_chunk,
                       q_chunk=q_chunk)


def exact_sse(pct, pcs, R, t, trim_fraction: float = 0.0,
              t_chunk=_T_CHUNK, q_chunk=_Q_CHUNK):
    """Exact SSE of transformed source vs target: sum_i min_j ||R p_i + t - q_j||^2.

    Parity with Registration::compute_sse_error(R, t)
    (registration.cu:62-86).  With trim_fraction > 0, sums only the smallest
    (1 - trim_fraction) fraction of residuals (functional trimming; the
    reference parses `trim` but never implements it).
    """
    pcs = jnp.asarray(pcs, jnp.float32)
    q = jnp.dot(pcs, jnp.asarray(R, jnp.float32).T,
                precision=jax.lax.Precision.HIGHEST) + jnp.asarray(t, jnp.float32)
    d2 = nearest_sqdist(q, pct, t_chunk=t_chunk, q_chunk=q_chunk)
    if trim_fraction > 0.0:
        ns = d2.shape[0]
        keep = max(1, int(round(ns * (1.0 - trim_fraction))))
        d2 = jnp.sort(d2)[:keep]
    return jnp.sum(d2)
