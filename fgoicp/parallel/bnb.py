"""Mesh-sharded inner R^3 BnB and batched ICP.

The reference's only parallel resource is one GPU's SIMT lanes plus 32
CUDA streams (/root/reference/fgoicp/common.hpp:138-164,
registration.cu:106-141).  Here the same work scales across a device
mesh:

* rotation groups (independent inner searches / ICP lanes) shard over the
  ``cubes`` axis — node parallelism, no communication except the lockstep
  loop-termination vote (a psum of live-group counts each frontier step);
* source points shard over the ``points`` axis — each device evaluates
  bound contributions for its point shard and the per-node sums are
  reduced with ``psum`` across devices (sequence-parallel style).

Padding keeps shapes divisible: group lanes are padded inactive, point
shards are padded with zero-weight sentinel points so sums are exact.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from typing import NamedTuple

from ..models import icp as icp_model
from ..ops import frontier as frontier_ops
from ..ops import pool_frontier
from . import sharding as sh


class PoolResult(NamedTuple):
    """Per-group results of a sharded pooled search (what GoICP consumes)."""
    best_ub: jnp.ndarray    # [G]
    best_err: jnp.ndarray   # [G] pruning incumbent (lb tightening input)
    best_t: jnp.ndarray     # [G, 3]
    evaluated: jnp.ndarray  # [G]
    steps: jnp.ndarray      # scalar
    dropped: jnp.ndarray    # [n_cubes] per-shard overflow drops
    dropped_lb: jnp.ndarray  # [G] min lb ever dropped (certificate clamp)


def _pad_groups(tree_arrays, g, gp):
    """Zero-pad the leading (group) axis from g to gp."""
    def pad(a):
        if a.shape[0] == gp:
            return a
        width = [(0, gp - g)] + [(0, 0)] * (a.ndim - 1)
        return jnp.pad(a, width)
    return [pad(jnp.asarray(a)) for a in tree_arrays]


def _pad_points(pcs, n_points):
    """Pad source points to a multiple of the points-axis size.

    Returns (padded points, weights) where padding lanes carry weight 0 so
    bound sums are unchanged.
    """
    pcs = jnp.asarray(pcs, jnp.float32)
    ns = pcs.shape[0]
    nsp = sh.pad_to_multiple(ns, n_points)
    w = jnp.ones((ns,), jnp.float32)
    if nsp != ns:
        pcs = jnp.pad(pcs, [(0, nsp - ns), (0, 0)])
        w = jnp.pad(w, [(0, nsp - ns)])
    return pcs, w


def bnb_r3_sharded(backend, pcs, R, rot_spans, fix_rot, best_sse,
                   sse_threshold, mesh: Mesh, group_active=None,
                   min_span=0.1, batch: int = 32, capacity: int = 4096,
                   max_steps: int = 100000, ref_compat_gamma: bool = False,
                   trim_keep: Optional[int] = None):
    """bnb_r3_batched over a (cubes, points) mesh; same return contract.

    The backend (proxy coreset / distance field) is replicated — it is
    read-only and shared by every lane; `pcs` is sharded over the points
    axis; all per-group arrays shard over the cubes axis.  Trimmed bounds
    compose with point sharding through the exact global top-k in
    bounds.reduce_point_terms (the padding mask marks pad lanes).
    """
    n_cubes = mesh.shape[sh.CUBES_AXIS]
    n_points = mesh.shape[sh.POINTS_AXIS]
    trim_ns = pcs.shape[0] if trim_keep is not None else None
    R = jnp.asarray(R, jnp.float32)
    g = R.shape[0]
    if group_active is None:
        group_active = jnp.ones((g,), bool)
    gp = sh.pad_to_multiple(g, n_cubes)
    R_p, spans_p, fix_p, act_p = _pad_groups(
        [R, jnp.asarray(rot_spans, jnp.float32), jnp.asarray(fix_rot, bool),
         jnp.asarray(group_active, bool)], g, gp)
    act_p = act_p & (jnp.arange(gp) < g)
    pcs_p, w_p = _pad_points(pcs, n_points)

    points_axis = sh.POINTS_AXIS if n_points > 1 else None
    lockstep = (sh.CUBES_AXIS,) if n_cubes > 1 else ()

    def local(backend_, pcs_, w_, R_, spans_, fix_, act_, best_sse_, thr_):
        st = frontier_ops.bnb_r3_batched(
            backend_, pcs_, R_, spans_, fix_, best_sse_, thr_,
            group_active=act_, min_span=min_span, batch=batch,
            capacity=capacity, max_steps=max_steps,
            ref_compat_gamma=ref_compat_gamma, trim_keep=trim_keep,
            points_axis=points_axis, lockstep_axes=lockstep,
            point_weights=(None if n_points == 1 else w_),
            trim_ns=trim_ns)
        return st

    gspec = P(sh.CUBES_AXIS)
    out_specs = frontier_ops.R3State(
        centers=gspec, spans=gspec, lbs=gspec, best_err=gspec,
        best_ub=gspec, best_t=gspec, active=gspec, steps=P(),
        evaluated=gspec, dropped=gspec, dropped_lb=gspec)
    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(sh.POINTS_AXIS), P(sh.POINTS_AXIS),
                  gspec, gspec, gspec, gspec, P(), P()),
        out_specs=out_specs, check_vma=False)
    st = fn(backend, pcs_p, w_p, R_p, spans_p, fix_p, act_p,
            jnp.float32(best_sse), jnp.float32(sse_threshold))
    trim = lambda a: a[:g]
    return frontier_ops.R3State(
        centers=trim(st.centers), spans=trim(st.spans), lbs=trim(st.lbs),
        best_err=trim(st.best_err), best_ub=trim(st.best_ub),
        best_t=trim(st.best_t), active=trim(st.active), steps=st.steps,
        evaluated=trim(st.evaluated), dropped=trim(st.dropped),
        dropped_lb=trim(st.dropped_lb))


def bnb_r3_pooled_sharded(backend, pcs, R, rot_spans, fix_rot, best_sse,
                          sse_threshold, mesh: Mesh, group_active=None,
                          min_span=0.1, lanes: int = 1024,
                          capacity: int = 32768, max_steps: int = 100000,
                          ref_compat_gamma: bool = False,
                          trim_keep: Optional[int] = None,
                          point_weights=None, point_deltas=None,
                          err_share_from=None,
                          trim_ns: Optional[int] = None,
                          pool_update: str = "sort"):
    """Pooled inner BnB over a (cubes, points) mesh.

    Each cubes-shard runs its own pool over its slice of the rotation
    groups (node parallelism); source points shard over the points axis
    with psum-reduced bounds.  Termination is a lockstep global vote, so
    shards with drained pools idle until every shard converges.

    Feature parity with the single-device pooled path: weighted source
    clusters (`point_weights`/`point_deltas` shard over the points axis
    alongside `pcs`), twin incumbent sharing (`err_share_from` holds
    GLOBAL group ids; donors resolve via a per-step all-gather over the
    cubes axis), and trimmed bounds (exact global top-k over point
    shards, bounds.reduce_point_terms).
    """
    n_cubes = mesh.shape[sh.CUBES_AXIS]
    n_points = mesh.shape[sh.POINTS_AXIS]
    if trim_keep is not None and trim_ns is None:
        trim_ns = pcs.shape[0]
    R = jnp.asarray(R, jnp.float32)
    g = R.shape[0]
    if group_active is None:
        group_active = jnp.ones((g,), bool)
    gp = sh.pad_to_multiple(g, n_cubes)
    R_p, spans_p, fix_p, act_p = _pad_groups(
        [R, jnp.asarray(rot_spans, jnp.float32), jnp.asarray(fix_rot, bool),
         jnp.asarray(group_active, bool)], g, gp)
    act_p = act_p & (jnp.arange(gp) < g)
    share_p = None
    if err_share_from is not None:
        # Pad with -1 (no donor); ids stay global — the pool resolves them
        # against an all-gathered incumbent vector.
        share_p = jnp.full((gp,), -1, jnp.int32).at[:g].set(
            jnp.asarray(err_share_from, jnp.int32))
    pcs_p, mask_p = _pad_points(pcs, n_points)
    if point_weights is not None:
        w_p = jnp.pad(jnp.asarray(point_weights, jnp.float32),
                      [(0, pcs_p.shape[0] - pcs.shape[0])])
    else:
        w_p = mask_p
    d_p = None
    if point_deltas is not None:
        d_p = jnp.pad(jnp.asarray(point_deltas, jnp.float32),
                      [(0, pcs_p.shape[0] - pcs.shape[0])])

    points_axis = sh.POINTS_AXIS if n_points > 1 else None
    lockstep = (sh.CUBES_AXIS,) if n_cubes > 1 else ()
    share_axis = sh.CUBES_AXIS if (n_cubes > 1 and share_p is not None) \
        else None
    # Weights are needed when the caller supplied them or padding is real.
    use_weights = point_weights is not None or n_points > 1

    def local(backend_, pcs_, w_, d_, R_, spans_, fix_, act_, share_,
              best_sse_, thr_):
        st = pool_frontier.bnb_r3_pooled(
            backend_, pcs_, R_, spans_, fix_, best_sse_, thr_,
            group_active=act_, min_span=min_span, lanes=lanes,
            capacity=capacity, max_steps=max_steps,
            ref_compat_gamma=ref_compat_gamma, trim_keep=trim_keep,
            points_axis=points_axis, lockstep_axes=lockstep,
            point_weights=(w_ if use_weights else None),
            point_deltas=d_, err_share_from=share_,
            err_share_axis=share_axis, trim_ns=trim_ns,
            pool_update=pool_update)
        return PoolResult(best_ub=st.best_ub, best_err=st.best_err,
                          best_t=st.best_t, evaluated=st.evaluated,
                          steps=st.steps, dropped=st.dropped[None],
                          dropped_lb=st.dropped_lb)

    gspec = P(sh.CUBES_AXIS)
    pspec = P(sh.POINTS_AXIS)
    out_specs = PoolResult(best_ub=gspec, best_err=gspec, best_t=gspec,
                           evaluated=gspec, steps=P(),
                           dropped=P(sh.CUBES_AXIS), dropped_lb=gspec)
    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), pspec, pspec, pspec,
                  gspec, gspec, gspec, gspec, gspec, P(), P()),
        out_specs=out_specs, check_vma=False)
    st = fn(backend, pcs_p, w_p, d_p, R_p, spans_p, fix_p, act_p, share_p,
            jnp.float32(best_sse), jnp.float32(sse_threshold))
    return PoolResult(best_ub=st.best_ub[:g], best_err=st.best_err[:g],
                      best_t=st.best_t[:g], evaluated=st.evaluated[:g],
                      steps=st.steps, dropped=st.dropped,
                      dropped_lb=st.dropped_lb[:g])


def so3_bnb_device_sharded(backend, pct, pcs, search_pcs, best_sse0,
                           best_R0, best_t0, sse_threshold, mesh: Mesh,
                           point_weights=None, point_deltas=None,
                           icp_search_target=None,
                           trim_keep: Optional[int] = None, **kw):
    """ops/so3_frontier.so3_bnb_device over a (cubes, points) mesh.

    The SO(3) frontier replicates across ALL shards (every shard runs
    the identical outer computation on collectively-identical values).
    The bound-evaluation source and the ICP/exact-SSE target shard over
    `points` (psum'd bound sums, pmin-vote correspondences); the CHILD
    EVALUATION work — inner pooled BnB + ICP lanes — slices over
    `cubes`, with the per-child results all-gathered before each
    replicated frontier update (so3_frontier module doc).  Note
    `rotation_batch` is PER CUBE SHARD in device mode: an n-shard run
    pops n * rotation_batch cubes per outer step, exploring the same
    outer octree as a single-device run with rotation_batch scaled by n
    (inner-pool scheduling order differs within the termination gap —
    so3_frontier module doc).

    Resumable like the unsharded call: `init_state`/`max_outer` ride
    through shard_map as REPLICATED arguments (not closure constants),
    so a chunked driver re-invoking with a new state + step cap hits
    the same compiled executable every chunk.
    """
    from ..ops import so3_frontier as so3_ops

    n_cubes = mesh.shape[sh.CUBES_AXIS]
    n_points = mesh.shape[sh.POINTS_AXIS]
    trim_ns = kw.pop("trim_ns", None)
    init_state = kw.pop("init_state", None)
    max_outer = kw.pop("max_outer", 10000)
    if init_state is None:
        # Materialize the root state here so shard_map sees ONE stable
        # input structure; so3_bnb_device then ignores best_sse0/R0/t0
        # (the state carries the incumbent — its docstring).
        init_state = so3_ops.initial_state(
            kw.get("capacity", 16384),
            history_capacity=kw.get("history_capacity", 32),
            best_sse=float(best_sse0),
            best_R=np.asarray(best_R0, np.float32),
            best_t=np.asarray(best_t0, np.float32))
    if trim_keep is not None and trim_ns is None:
        trim_ns = search_pcs.shape[0]
    search_p, mask_p = _pad_points(search_pcs, n_points)
    if point_weights is not None:
        w_p = jnp.pad(jnp.asarray(point_weights, jnp.float32),
                      [(0, search_p.shape[0] - search_pcs.shape[0])])
    else:
        w_p = mask_p
    d_p = jnp.zeros((search_p.shape[0],), jnp.float32)
    if point_deltas is not None:
        d_p = d_p.at[:search_pcs.shape[0]].set(
            jnp.asarray(point_deltas, jnp.float32))
    # ICP/exact-SSE target: pad with far-away rows (pmin never votes
    # for them) and give each shard its global row offset.
    pct = jnp.asarray(pct, jnp.float32)
    nt = pct.shape[0]
    ntp = sh.pad_to_multiple(nt, n_points)
    if ntp != nt:
        pct = jnp.concatenate(
            [pct, jnp.full((ntp - nt, 3), 1e6, jnp.float32)])
    points_axis = sh.POINTS_AXIS if n_points > 1 else None

    def local(backend_, pct_, pcs_, search_, w_, d_, icp_tgt_, sse0_,
              R0_, t0_, thr_, st0_, max_outer_):
        offset = None
        if points_axis is not None:
            offset = (jax.lax.axis_index(points_axis).astype(jnp.int32)
                      * (ntp // n_points))
        return so3_ops.so3_bnb_device(
            backend_, pct_, pcs_, search_, sse0_, R0_, t0_, thr_,
            point_weights=w_, point_deltas=(
                d_ if point_deltas is not None else None),
            icp_search_target=icp_tgt_, trim_keep=trim_keep,
            points_axis=points_axis, target_offset=offset,
            trim_ns=trim_ns,
            cubes_axis=(sh.CUBES_AXIS if n_cubes > 1 else None),
            n_cubes=n_cubes, init_state=st0_, max_outer=max_outer_,
            **kw)

    pspec = P(sh.POINTS_AXIS)
    rep = P()
    state_spec = so3_ops.SO3State(
        *([rep] * len(so3_ops.SO3State._fields)))
    out_specs = state_spec
    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(rep, pspec, rep, pspec, pspec, pspec, rep,
                  rep, rep, rep, rep, state_spec, rep),
        out_specs=out_specs, check_vma=False)
    return fn(backend, pct, jnp.asarray(pcs, jnp.float32), search_p,
              w_p, d_p, icp_search_target, jnp.float32(best_sse0),
              jnp.asarray(best_R0, jnp.float32),
              jnp.asarray(best_t0, jnp.float32),
              jnp.float32(sse_threshold),
              jax.tree.map(jnp.asarray, init_state),
              jnp.int32(max_outer))


def icp_sharded(pct, pcs, R0, t0, mesh: Mesh, active=None,
                max_iter: int = 100, convergence_threshold=0.005,
                trim_keep=None, **kw):
    """icp_batched over the mesh: ICP lanes shard over the cubes axis
    (embarrassingly parallel), and the TARGET cloud shards over the
    points axis — correspondences resolve via a pmin distance vote and a
    masked-psum gather (models/icp.py target_axis protocol).
    """
    n_cubes = mesh.shape[sh.CUBES_AXIS]
    n_points = mesh.shape[sh.POINTS_AXIS]
    R0 = jnp.asarray(R0, jnp.float32)
    g = R0.shape[0]
    if active is None:
        active = jnp.ones((g,), bool)
    gp = sh.pad_to_multiple(g, n_cubes)
    R_p, t_p, act_p = _pad_groups(
        [R0, jnp.asarray(t0, jnp.float32), jnp.asarray(active, bool)], g, gp)
    # Padded lanes get identity rotations so the math stays well-posed.
    if gp != g:
        eye = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (gp - g, 3, 3))
        R_p = R_p.at[g:].set(eye)
    act_p = act_p & (jnp.arange(gp) < g)

    # Target padding rows sit far away so they never win the pmin vote.
    pct = jnp.asarray(pct, jnp.float32)
    nt = pct.shape[0]
    ntp = sh.pad_to_multiple(nt, n_points)
    if ntp != nt:
        pct = jnp.concatenate(
            [pct, jnp.full((ntp - nt, 3), 1e6, jnp.float32)])
    target_axis = sh.POINTS_AXIS if n_points > 1 else None

    def local(pct_, pcs_, R_, t_, act_):
        offset = None
        if target_axis is not None:
            offset = (jax.lax.axis_index(target_axis).astype(jnp.int32)
                      * (ntp // n_points))
        return icp_model.icp_batched(
            pct_, pcs_, R_, t_, active=act_, max_iter=max_iter,
            convergence_threshold=convergence_threshold,
            trim_keep=trim_keep, target_axis=target_axis,
            target_offset=offset, **kw)

    gspec = P(sh.CUBES_AXIS)
    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(sh.POINTS_AXIS), P(), gspec, gspec, gspec),
        out_specs=(gspec, gspec, gspec), check_vma=False)
    sse, R, t = fn(pct, jnp.asarray(pcs, jnp.float32), R_p, t_p, act_p)
    return sse[:g], R[:g], t[:g]
