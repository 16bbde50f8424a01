"""Batched Procrustes ICP, fully on-device.

Semantics parity with IterativeClosestPoint3D::run
(/root/reference/fgoicp/icp3d.cu:80-108): apply the initial (R0, t0), then
iterate (find correspondences -> Procrustes -> compose -> exact SSE) while
the relative SSE improvement exceeds the convergence threshold, up to
max_iter; return the better of the last two iterates.

Differences: an arbitrary batch of ICP problems (one per
candidate rotation node) runs in lockstep inside a single lax.while_loop
with per-problem convergence masks — replacing the reference's one
sequential ICP per promising BnB node (fgoicp.cpp:76) — and the 3x3 SVD
stays on-device (ops/procrustes.py) instead of round-tripping to Eigen.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import nn as nn_ops
from ..ops import procrustes as proc_ops

BIG = 1e10  # reference M_INF


class ICPState(NamedTuple):
    it: jnp.ndarray        # scalar int32
    sse: jnp.ndarray       # [G]
    last_sse: jnp.ndarray  # [G]
    R: jnp.ndarray         # [G, 3, 3]
    t: jnp.ndarray         # [G, 3]
    last_R: jnp.ndarray    # [G, 3, 3]
    last_t: jnp.ndarray    # [G, 3]
    cur: jnp.ndarray       # [G, ns, 3] transformed source
    d2: jnp.ndarray        # [G, ns] NN sq-distances of `cur` (carried)
    idx: jnp.ndarray       # [G, ns] NN indices of `cur` (carried)
    done: jnp.ndarray      # [G] bool


def _masked(pred, new, old):
    """Select new where pred (per-group), broadcasting over trailing dims."""
    shape = pred.shape + (1,) * (new.ndim - pred.ndim)
    return jnp.where(pred.reshape(shape), new, old)


@functools.partial(
    jax.jit, static_argnames=("max_iter", "t_chunk", "q_chunk", "trim_keep",
                              "target_axis")
)
def icp_batched(pct, pcs, R0, t0, active=None, max_iter: int = 100,
                convergence_threshold=0.005, t_chunk=2048, q_chunk=8192,
                trim_keep=None, target_axis=None, target_offset=None, point_weights=None):
    """Run G ICP problems in lockstep.

    pct: [nt, 3] target; pcs: [ns, 3] source (shared across the batch)
    or [G, ns, 3] (one source cloud per lane — the batched multi-pair
    serving mode, models/serving.py).
    R0: [G, 3, 3], t0: [G, 3] initial transforms.
    active: [G] bool — inactive lanes are skipped entirely.
    trim_keep: keep only the K best correspondences per iteration and sum
    only the K smallest residuals (trimmed ICP — an extension the reference
    parses but never implements, SURVEY §2 row 2).
    point_weights: [ns] or [G, ns] per-point weights — 0 marks padding
    lanes (the ragged serving batch), soft values weight Procrustes and
    the SSE.  Combines multiplicatively with the trim mask.
    target_axis/target_offset: when the TARGET cloud is sharded over a
    mesh axis (`pct` is this device's slice starting at global row
    `target_offset`), correspondences resolve via a pmin vote: global
    min distance by pmin, the owner shard contributes the winning point
    through a masked psum.  Padding rows in a shard must sit far away
    (they never win the vote).
    Returns (sse [G], R [G, 3, 3], t [G, 3]).
    """
    pct = jnp.asarray(pct, jnp.float32)
    pcs = jnp.asarray(pcs, jnp.float32)
    R0 = jnp.asarray(R0, jnp.float32)
    t0 = jnp.asarray(t0, jnp.float32)
    g = R0.shape[0]
    ns = pcs.shape[-2]
    nt_local = pct.shape[0]
    if active is None:
        active = jnp.ones((g,), bool)
    w_pt = None
    if point_weights is not None:
        if trim_keep is not None and trim_keep < ns:
            # Padding zeros would displace real points from the trim
            # keep-set; the ragged serving path forbids trimming instead.
            raise ValueError("point_weights cannot combine with trim_keep")
        w_pt = jnp.broadcast_to(
            jnp.asarray(point_weights, jnp.float32), (g, ns))

    # Per-lane sources ([G, ns, 3]) only affect the initial transform;
    # the loop body operates on the carried `cur` points either way.
    src_spec = "gnc" if pcs.ndim == 3 else "nc"
    cur0 = jnp.einsum(f"grc,{src_spec}->gnr", R0, pcs,
                      precision=jax.lax.Precision.HIGHEST) + t0[:, None, :]

    def nn_query(cur):
        d2, idx = nn_ops.nearest_neighbor(
            cur.reshape(g * ns, 3), pct, t_chunk=t_chunk, q_chunk=q_chunk)
        if target_axis is not None:
            gidx = idx + target_offset
            best_d2 = jax.lax.pmin(d2, target_axis)
            # Owner shards vote with their global index; ties resolve to
            # the smallest index, deterministically.
            vote = jnp.where(d2 <= best_d2, gidx, jnp.int32(2 ** 31 - 1))
            best_idx = jax.lax.pmin(vote, target_axis)
            return best_d2.reshape(g, ns), best_idx.reshape(g, ns)
        return d2.reshape(g, ns), idx.reshape(g, ns)

    def gather_corr(idx):
        """Correspondence coordinates for global indices [G, ns]."""
        if target_axis is None:
            return pct[idx]
        local = idx - target_offset
        in_range = (local >= 0) & (local < nt_local)
        pts = pct[jnp.clip(local, 0, nt_local - 1)]
        pts = jnp.where(in_range[..., None], pts, 0.0)
        return jax.lax.psum(pts, target_axis)

    def trimmed_sum(d2):
        if w_pt is not None:
            d2 = d2 * w_pt
        if trim_keep is None or trim_keep >= ns:
            return jnp.sum(d2, axis=-1)
        return -jnp.sum(jax.lax.top_k(-d2, trim_keep)[0], axis=-1)

    def trim_mask(d2):
        if trim_keep is None or trim_keep >= ns:
            return w_pt
        thr = -jax.lax.top_k(-d2, trim_keep)[0][..., -1]
        m = (d2 <= thr[..., None]).astype(jnp.float32)
        return m if w_pt is None else m * w_pt

    def body(s: ICPState) -> ICPState:
        run = ~s.done
        # Correspondences on the current (pre-update) points (icp3d.cu:146)
        # — carried from the previous iteration's single NN pass: the
        # reference queries NN twice per iteration (correspondences, then
        # exact SSE of the updated pose, icp3d.cu:99-103), but the SSE
        # query of iteration k IS the correspondence query of iteration
        # k+1, so one pass per iteration computes identical values.
        corr = gather_corr(s.idx)  # [G, ns, 3]
        R_, t_ = proc_ops.procrustes(s.cur, corr, mask=trim_mask(s.d2))
        new_cur = jnp.einsum("grc,gnc->gnr", R_, s.cur, precision=jax.lax.Precision.HIGHEST) + t_[:, None, :]
        new_R = jnp.einsum("gab,gbc->gac", R_, s.R, precision=jax.lax.Precision.HIGHEST)
        new_t = jnp.einsum("gab,gb->ga", R_, s.t, precision=jax.lax.Precision.HIGHEST) + t_
        d2n, idxn = nn_query(new_cur)
        new_sse = trimmed_sum(d2n)

        sse = _masked(run, new_sse, s.sse)
        last_sse = _masked(run, s.sse, s.last_sse)
        R = _masked(run, new_R, s.R)
        t = _masked(run, new_t, s.t)
        last_R = _masked(run, s.R, s.last_R)
        last_t = _masked(run, s.t, s.last_t)
        cur = _masked(run, new_cur, s.cur)
        d2 = _masked(run, d2n, s.d2)
        idx = _masked(run, idxn, s.idx)
        # Reference loop guard: continue while
        # (last_sse - sse) > threshold * last_sse (icp3d.cu:94).
        conv = (last_sse - sse) <= convergence_threshold * last_sse
        done = s.done | (run & conv)
        return ICPState(s.it + 1, sse, last_sse, R, t, last_R, last_t,
                        cur, d2, idx, done)

    d2_0, idx_0 = nn_query(cur0)
    init = ICPState(
        it=jnp.int32(0),
        sse=jnp.full((g,), BIG, jnp.float32),
        last_sse=jnp.full((g,), 2 * BIG, jnp.float32),
        R=R0, t=t0,
        last_R=R0, last_t=t0,
        cur=cur0,
        d2=d2_0, idx=idx_0,
        done=~active,
    )

    def cond(s: ICPState):
        return (s.it < max_iter) & jnp.any(~s.done)

    final = jax.lax.while_loop(cond, body, init)

    # Return the better of the last two iterates (icp3d.cu:106-107).
    better = final.sse < final.last_sse
    sse = jnp.where(better, final.sse, final.last_sse)
    R = _masked(better, final.R, final.last_R)
    t = _masked(better, final.t, final.last_t)
    return sse, R, t


@functools.partial(jax.jit, static_argnames=("trim_keep", "target_axis"))
def exact_sse_batched(pct, pcs, R, t, trim_keep=None, target_axis=None,
                      point_weights=None):
    """Exact (optionally trimmed) SSE of G poses against the full target.

    pcs: [ns, 3] shared source or [G, ns, 3] per-lane sources (serving
    mode).  One NN pass — used to re-anchor incumbents produced by proxy-target
    search ICPs on the true objective (models/goicp.py).  When the
    TARGET is sharded over mesh axis `target_axis` (pct holds this
    device's slice), per-query minima resolve with a pmin before the
    source-axis sum (padding rows must sit far away).

    Scaling note: under target sharding each device
    does g*ns queries against its nt/n-row slice — the proper 1/n split
    of the g*ns*nt op count, NOT redundant work.  The redundancy to avoid
    is at the CALL SITE: a pose that just finished a full-target
    icp_batched already carries this exact SSE (the single-NN-per-
    iteration design makes the last correspondence query the scorer), so
    only proxy-iterated poses should ever be re-scored here."""
    pct = jnp.asarray(pct, jnp.float32)
    pcs = jnp.asarray(pcs, jnp.float32)
    R = jnp.asarray(R, jnp.float32)
    g, ns = R.shape[0], pcs.shape[-2]
    src_spec = "gnc" if pcs.ndim == 3 else "nc"
    cur = jnp.einsum(f"grc,{src_spec}->gnr", R, pcs,
                     precision=jax.lax.Precision.HIGHEST) \
        + jnp.asarray(t, jnp.float32)[:, None, :]
    d2 = nn_ops.nearest_sqdist(cur.reshape(g * ns, 3), pct).reshape(g, ns)
    if target_axis is not None:
        d2 = jax.lax.pmin(d2, target_axis)
    if point_weights is not None:
        if trim_keep is not None and trim_keep < ns:
            raise ValueError("point_weights cannot combine with trim_keep")
        d2 = d2 * jnp.broadcast_to(
            jnp.asarray(point_weights, jnp.float32), (g, ns))
    if trim_keep is not None and trim_keep < ns:
        return -jnp.sum(jax.lax.top_k(-d2, trim_keep)[0], axis=-1)
    return jnp.sum(d2, axis=-1)


def icp_register(pct, pcs, R0=None, t0=None, max_iter: int = 100,
                 convergence_threshold: float = 0.005, **kw):
    """Single-pair ICP (reference config 1: plain ICP on a cloud pair)."""
    R0 = jnp.eye(3) if R0 is None else jnp.asarray(R0, jnp.float32)
    t0 = jnp.zeros(3) if t0 is None else jnp.asarray(t0, jnp.float32)
    sse, R, t = icp_batched(
        pct, pcs, R0[None], t0[None], max_iter=max_iter,
        convergence_threshold=convergence_threshold, **kw)
    return sse[0], R[0], t[0]
