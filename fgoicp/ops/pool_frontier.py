"""Pooled inner R^3 BnB: one global device frontier shared by all groups.

ops/frontier.py runs G independent per-group frontiers in lockstep and
pops a fixed batch per group per step.  Groups converge at very different
rates, so most lanes evaluate masked no-ops — measured 8.5% lane
utilization on the bunny benchmark (166k real nodes over 954 steps of
64x32 lanes).  This module replaces the per-group frontiers with ONE
pool of (group id, center, span, lb) nodes sorted by lower bound:

  each step:
    pop the globally best L nodes (any group) ->
    evaluate all L lanes in one fused kernel
    (pallas_bounds.fused_bounds_lanes, one program per lane) ->
    per-group incumbent updates via one-hot reductions ->
    split survivors into octree children, merge, re-sort, truncate.

Every lane is a real node until the pool drains below L, so device
utilization tracks the actual work-list size.  Group semantics (per-group
incumbents, termination gaps, min-ub results) are identical to
frontier.bnb_r3_batched; only the EXPANSION ORDER differs — global
best-first instead of per-group best-first — which is at least as
work-efficient (nodes are popped in the order most likely to prune).

Search-semantics parity with the reference inner loop
(/root/reference/fgoicp/fgoicp.cpp:102-174) matches frontier.py's:
termination gap, lb-inheriting children, min-span cutoff.

Pool overflow and the optimality certificate: when valid nodes exceed
`capacity`, the worst-lb nodes are dropped (counted in `dropped`).  A
dropped node's subtree is never explored, so the pool minimum alone is
NOT a valid lower bound on the group's objective once a drop has
occurred — the per-group minimum lb ever dropped is therefore tracked in
`dropped_lb` ([G], +INVALID when no drops) and the consumer must fold it
in: lb_sound = min(search result, dropped_lb[g]).  models/goicp.py does
exactly that, so capacity overflow can only loosen the certificate,
never silently void it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from . import bounds as bounds_ops
from . import geometry as geo
from . import pallas_bounds

INVALID = jnp.float32(1e30)
BIG = jnp.float32(1e10)


class PoolState(NamedTuple):
    lbs: jnp.ndarray        # [CP] (INVALID marks empty slots)
    gids: jnp.ndarray       # [CP] int32
    centers: jnp.ndarray    # [CP, 3]
    spans: jnp.ndarray      # [CP]
    best_err: jnp.ndarray   # [G] per-group pruning incumbent
    best_ub: jnp.ndarray    # [G] min upper bound seen
    best_t: jnp.ndarray     # [G, 3]
    active: jnp.ndarray     # [G] bool
    steps: jnp.ndarray      # scalar int32
    evaluated: jnp.ndarray  # [G] int32
    dropped: jnp.ndarray    # scalar int32 (pool-overflow losses)
    dropped_lb: jnp.ndarray  # [G] min lb ever dropped (INVALID = none)


def _eval_lanes_xla(backend, base, gids, t_lanes, gam_ub, gam_lb,
                    gam_t_lanes, point_weights, trim_keep,
                    points_axis=None, trim_ns=None, clustered_trim=False):
    """XLA fallback lane evaluator (CPU tests, LUT backend, trimming)."""
    q = base[gids] + t_lanes[:, None, :]                     # [L, ns, 3]
    d_ub, d_lb = bounds_ops.distance_estimates(backend, q)   # [L, ns]
    ub_pt = jnp.square(jnp.maximum(d_ub - gam_ub[gids], 0.0))
    lb_pt = jnp.square(jnp.maximum(
        d_lb - gam_lb[gids] - gam_t_lanes[:, None], 0.0))
    if clustered_trim:
        # Weighted member-level trim over clusters (bounds module doc).
        return bounds_ops.reduce_clustered_trimmed(
            lb_pt, ub_pt, point_weights, trim_keep, trim_ns, points_axis)
    lb = bounds_ops.reduce_point_terms(lb_pt, point_weights, trim_keep,
                                       points_axis, trim_ns,
                                       drop_mode="over")
    ub = bounds_ops.reduce_point_terms(ub_pt, point_weights, trim_keep,
                                       points_axis, trim_ns,
                                       drop_mode="under")
    return lb, ub


def _count_less(a, v, strict: bool):
    """count of entries of sorted `a` [n] that are < v (strict) or <= v,
    per query v [m] — a fori_loop binary search (depth ceil(log2 n+1))
    of vectorized clipped gathers, so each pass is one gather per
    query."""
    n = a.shape[0]
    depth = max(1, int(n).bit_length())

    def body(_, c):
        lo, hi = c
        mid = (lo + hi) >> 1
        am = jnp.take(a, mid, mode="clip")
        pred = (am < v) if strict else (am <= v)
        pred = pred & (lo < hi)
        return jnp.where(pred, mid + 1, lo), jnp.where(pred, hi, mid)

    lo = jnp.zeros(v.shape, jnp.int32)
    hi = jnp.full(v.shape, n, jnp.int32)
    lo, _ = jax.lax.fori_loop(0, depth, body, (lo, hi))
    return lo


def _merge_sorted(a_lb, b_lb, a_payload, b_payload):
    """Stable merge of two lb-sorted runs (a first on ties): returns the
    merged (lb [Na+Nb], payload [Na+Nb, K]).  One binary-search pass per
    side + one i32 scatter (a permutation) + one packed row gather —
    replacing the full argsort over the concatenation (the pooled-step
    fixed intercept)."""
    na, nb = a_lb.shape[0], b_lb.shape[0]
    ia = jnp.arange(na, dtype=jnp.int32)
    ib = jnp.arange(nb, dtype=jnp.int32)
    pos_a = ia + _count_less(b_lb, a_lb, strict=True)
    pos_b = ib + _count_less(a_lb, b_lb, strict=False)
    inv = jnp.zeros((na + nb,), jnp.int32)
    inv = inv.at[pos_a].set(ia)
    inv = inv.at[pos_b].set(na + ib)
    lb = jnp.concatenate([a_lb, b_lb])[inv]
    payload = jnp.concatenate([a_payload, b_payload])[inv]
    return lb, payload


@functools.partial(jax.jit, static_argnames=(
    "lanes", "capacity", "max_steps", "ref_compat_gamma", "trim_keep",
    "points_axis", "lockstep_axes", "err_share_axis",
    "trim_ns", "pool_update"))
def bnb_r3_pooled(backend, pcs, R, rot_spans, fix_rot, best_sse,
                  sse_threshold, group_active=None, min_span=0.1,
                  lanes: int = 1024, capacity: int = 32768,
                  max_steps: int = 100000, ref_compat_gamma: bool = False,
                  trim_keep: Optional[int] = None,
                  points_axis=None, lockstep_axes=(),
                  point_weights=None, point_deltas=None,
                  err_share_from=None, err_share_axis=None,
                  trim_ns: Optional[int] = None,
                  pool_update: str = "sort"):
    """Pool-scheduled equivalent of frontier.bnb_r3_batched.

    Same arguments and result contract (per-group best_ub/best_t/...),
    plus `lanes` (device width per step) and pool `capacity`.
    Proxy backends without trimming evaluate their lanes in the Pallas
    lane kernel on the GPU.

    err_share_from [G] int32 (optional): index of a group whose incumbent
    validly upper-bounds this group's objective (-1 = none).  The engine
    points each gamma-relaxed lb-pass group at its fixed-rotation twin:
    relu(d - gamma_r)^2 <= d^2 pointwise, so the twin's incumbent prunes
    the relaxed search too.  When the group axis is sharded over a mesh
    axis, pass that axis name as `err_share_axis` and GLOBAL group ids in
    err_share_from — donor incumbents are all-gathered each step so twins
    on different shards still share.
    """
    R = jnp.asarray(R, jnp.float32)
    g = R.shape[0]
    if capacity < g:
        raise ValueError(
            f"pool capacity {capacity} < {g} groups: root nodes would be "
            f"dropped and their searches would never terminate")
    pcs = jnp.asarray(pcs, jnp.float32)
    if group_active is None:
        group_active = jnp.ones((g,), bool)
    clustered_trim = trim_keep is not None and point_deltas is not None
    if clustered_trim and (point_weights is None or trim_ns is None):
        raise ValueError(
            "clustered trimming needs point_weights (member counts) and "
            "trim_ns (global member count)")
    # Trimmed lanes take the XLA lane path: the fused kernel sums every
    # point and has no drop-sum stage.
    use_kernel = (isinstance(backend, bounds_ops.ProxyBackend)
                  and trim_keep is None and bounds_ops._use_fused_kernel())

    base = jnp.einsum("grc,nc->gnr", R, pcs,
                      precision=jax.lax.Precision.HIGHEST)   # [G, ns, 3]
    norms = jnp.linalg.norm(pcs, axis=-1)
    gam_ub, gam_lb = bounds_ops.gamma_arrays(
        norms, rot_spans, fix_rot, ref_compat=ref_compat_gamma,
        point_deltas=point_deltas)                           # [G, ns] x2
    if use_kernel:
        slack = backend.coreset.eps

    cp = capacity
    gid0 = jnp.arange(cp, dtype=jnp.int32) % g
    in_init = jnp.arange(cp) < g
    lbs0 = jnp.where(in_init & group_active[gid0], 0.0, INVALID)
    if pool_update not in ("sort", "merge"):
        raise ValueError(f"Unknown pool_update mode: {pool_update!r}")
    spans0 = jnp.where(in_init, 1.0, 0.0).astype(jnp.float32)
    if pool_update == "merge":
        # The merge update requires a SORTED pool invariant; inactive
        # groups leave INVALID holes among the first g root slots, so
        # sort once at init (outside the while_loop).
        order0 = jnp.argsort(lbs0)
        lbs0 = lbs0[order0]
        gid0 = gid0[order0]
        spans0 = spans0[order0]
    state0 = PoolState(
        lbs=lbs0.astype(jnp.float32),
        gids=gid0,
        centers=jnp.zeros((cp, 3), jnp.float32),
        spans=spans0,
        best_err=jnp.full((g,), jnp.float32(best_sse)),
        best_ub=jnp.full((g,), BIG),
        best_t=jnp.zeros((g, 3), jnp.float32),
        active=jnp.asarray(group_active),
        steps=jnp.int32(0),
        evaluated=jnp.zeros((g,), jnp.int32),
        dropped=jnp.int32(0),
        dropped_lb=jnp.full((g,), INVALID),
    )
    grange = jnp.arange(g, dtype=jnp.int32)

    def group_minlb(lbs, gids):
        """Min lb per group over the pool ([G])."""
        onehot = gids[:, None] == grange[None, :]            # [CP, G]
        return jnp.min(jnp.where(onehot, lbs[:, None], INVALID), axis=0)

    def cond(s: PoolState):
        alive = jnp.sum(s.active.astype(jnp.int32))
        axes = tuple(lockstep_axes) + (
            (points_axis,) if points_axis is not None else ())
        if axes:
            alive = jax.lax.psum(alive, axes)
        return (alive > 0) & (s.steps < max_steps)

    def body(s: PoolState) -> PoolState:
        pop_lb = s.lbs[:lanes]
        pop_gid = s.gids[:lanes]
        pop_c = s.centers[:lanes]
        pop_s = s.spans[:lanes]
        lane_valid = ((pop_lb < INVALID)
                      & (pop_lb < s.best_err[pop_gid])
                      & s.active[pop_gid])
        gam_t_l = geo.translation_uncertainty_radius(pop_s)  # [L]

        if use_kernel:
            lb_e, ub_e = pallas_bounds.fused_bounds_lanes(
                base, pop_gid, pop_c, backend.coreset.points, gam_ub,
                gam_t_l, slack, point_weights=point_weights,
                gam_lb=gam_lb)
            if points_axis is not None:
                lb_e = jax.lax.psum(lb_e, points_axis)
                ub_e = jax.lax.psum(ub_e, points_axis)
        else:
            lb_e, ub_e = _eval_lanes_xla(
                backend, base, pop_gid, pop_c, gam_ub, gam_lb, gam_t_l,
                point_weights, trim_keep, points_axis, trim_ns,
                clustered_trim=clustered_trim)
        lb_e = jnp.where(lane_valid, lb_e, BIG)
        ub_e = jnp.where(lane_valid, ub_e, BIG)

        # Per-group incumbent updates via one-hot reductions [L, G].
        onehot = pop_gid[:, None] == grange[None, :]
        ub_grid = jnp.where(onehot, ub_e[:, None], BIG)
        grp_min_ub = jnp.min(ub_grid, axis=0)                # [G]
        grp_arg = jnp.argmin(ub_grid, axis=0)                # [G] lane idx
        best_ub = jnp.where(s.active,
                            jnp.minimum(s.best_ub, grp_min_ub), s.best_ub)
        improve = s.active & (grp_min_ub < s.best_err)
        best_err = jnp.where(improve, grp_min_ub, s.best_err)
        best_t = jnp.where(improve[:, None], pop_c[grp_arg], s.best_t)
        if err_share_from is not None:
            share = jnp.asarray(err_share_from, jnp.int32)
            if err_share_axis is not None:
                pool_err = jax.lax.all_gather(
                    best_err, err_share_axis, tiled=True)  # [G global]
            else:
                pool_err = best_err
            donor = pool_err[jnp.maximum(share, 0)]
            best_err = jnp.where(share >= 0,
                                 jnp.minimum(best_err, donor), best_err)

        # Children inherit the evaluated lb (fgoicp.cpp:159-166).
        split = lane_valid & (lb_e < best_err[pop_gid]) & (pop_s >= min_span)
        ch_c, ch_s = geo.split_octree(pop_c, pop_s)          # [L, 8, 3]
        ch_lb = jnp.broadcast_to(
            jnp.where(split, lb_e, INVALID)[:, None], (lanes, 8))
        ch_gid = jnp.broadcast_to(pop_gid[:, None], (lanes, 8))

        if pool_update == "sort":
            all_lb = jnp.concatenate([s.lbs[lanes:], ch_lb.reshape(-1)])
            all_gid = jnp.concatenate([s.gids[lanes:], ch_gid.reshape(-1)])
            all_c = jnp.concatenate([s.centers[lanes:],
                                     ch_c.reshape(-1, 3)])
            all_s = jnp.concatenate([s.spans[lanes:], ch_s.reshape(-1)])
            # Re-check dominance against the fresher incumbent and
            # inactive groups before sorting (ref pops-and-drops,
            # fgoicp.cpp:127).
            keep = (all_lb < INVALID) & (all_lb < best_err[all_gid]) \
                & s.active[all_gid]
            all_lb = jnp.where(keep, all_lb, INVALID)
            order = jnp.argsort(all_lb)
            # One packed row gather for all payloads (4 separate [N]
            # gathers measurably cost more than one [N, 5] row gather).
            packed = jnp.concatenate(
                [all_gid.astype(jnp.float32)[:, None], all_c,
                 all_s[:, None]], axis=1)[order]              # [N, 5]
            new_lb = all_lb[order[:cp]]
            rest_lb = all_lb[order[cp:]]
            rest_gid = packed[cp:, 0].astype(jnp.int32)
        else:
            # "merge": the pool suffix is sorted by INVARIANT (this very
            # update emits sorted pools; state0 is sorted).  Dominance /
            # inactive-group filtering moves to POP time (lane_valid
            # already re-checks both).  NEAR-exact, not exact, parity
            # with "sort": dominance is a PER-GROUP threshold
            # (lb >= best_err[gid]), so a dominated entry of a group
            # with a small incumbent can sort before a valid entry of a
            # group with a large one and waste its pop lane (masked
            # no-op) — measured low-single-digit extra steps on the CPU
            # equivalence tests.  Convergence, certificates, and optima
            # are unaffected: the gap check sees lb >= best_err for
            # dominated entries, and dropped_lb filters them (below).
            # Dominated entries also occupy capacity until truncated
            # off the tail, so overflow can start earlier; dropped_lb
            # keeps the certificate sound either way.
            # Children share their parent's lb, so sorting L parent keys
            # (stable) and broadcasting the permutation sorts all 8L
            # children in the same stable order a full argsort gives.
            par_key = jnp.where(split, lb_e, INVALID)
            par_order = jnp.argsort(par_key)                  # [L]
            b_lb = jnp.repeat(par_key[par_order], 8)          # [8L]
            ch_packed = jnp.concatenate(
                [ch_gid[..., None].astype(jnp.float32), ch_c,
                 ch_s[..., None]], axis=-1)                   # [L, 8, 5]
            b_payload = ch_packed[par_order].reshape(-1, 5)
            a_lb = s.lbs[lanes:]
            a_payload = jnp.concatenate(
                [s.gids[lanes:].astype(jnp.float32)[:, None],
                 s.centers[lanes:], s.spans[lanes:, None]], axis=1)
            all_lb, packed = _merge_sorted(a_lb, b_lb, a_payload,
                                           b_payload)
            keep = (all_lb < INVALID) \
                & (all_lb < best_err[packed[:, 0].astype(jnp.int32)]) \
                & s.active[packed[:, 0].astype(jnp.int32)]
            new_lb = all_lb[:cp]
            rest_lb = jnp.where(keep[cp:], all_lb[cp:], INVALID)
            rest_gid = packed[cp:, 0].astype(jnp.int32)
        new_gid = packed[:cp, 0].astype(jnp.int32)
        new_c = packed[:cp, 1:4]
        new_s = packed[:cp, 4]
        n_valid = jnp.sum(keep)
        dropped = s.dropped + jnp.maximum(n_valid - cp, 0).astype(jnp.int32)
        # Certificate soundness under overflow: remember the minimum lb
        # among dropped (still-valid) nodes per group so the consumer can
        # clamp the group's final lower bound with it (see module doc).
        rest_onehot = rest_gid[:, None] == grange[None, :]
        step_drop_min = jnp.min(
            jnp.where(rest_onehot, rest_lb[:, None], INVALID), axis=0)
        dropped_lb = jnp.minimum(s.dropped_lb, step_drop_min)

        minlb = group_minlb(new_lb, new_gid)                 # [G]
        converged = (best_err - minlb) < sse_threshold
        empty = minlb >= INVALID
        active = s.active & ~(converged | empty)

        evaluated = s.evaluated + jnp.sum(
            jnp.where(onehot & lane_valid[:, None], 1, 0), axis=0)

        return PoolState(
            lbs=new_lb, gids=new_gid, centers=new_c, spans=new_s,
            best_err=best_err, best_ub=best_ub, best_t=best_t,
            active=active, steps=s.steps + 1, evaluated=evaluated,
            dropped=dropped, dropped_lb=dropped_lb)

    s = jax.lax.while_loop(cond, body, state0)
    # A max_steps exit leaves still-active groups with unexplored frontier
    # nodes whose lb can sit below the group's returned search result; fold
    # the surviving per-group frontier minimum into dropped_lb so the
    # consumer's clamp (min(search result, dropped_lb)) stays a sound lower
    # bound on every exit path, not just capacity overflow.  Converged /
    # drained groups (active=False) keep the gap-termination guarantee and
    # are left untouched.
    exit_minlb = group_minlb(s.lbs, s.gids)
    return s._replace(dropped_lb=jnp.where(
        s.active, jnp.minimum(s.dropped_lb, exit_minlb), s.dropped_lb))
