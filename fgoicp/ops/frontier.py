"""Batched R^3 branch-and-bound on device frontiers.

Replaces the reference's host priority queue + pop-32 + one-CUDA-stream-
per-node inner loop (/root/reference/fgoicp/fgoicp.cpp:102-174,
common.hpp:110-128,138-164) with a device-frontier design: G independent
searches (one per rotation candidate) advance in lockstep inside a single
jitted lax.while_loop.  Each search keeps a fixed-capacity frontier of
translation nodes sorted by lower bound; every step pops the best B nodes
across all G groups, evaluates their bounds in one fused kernel
(ops/bounds.py), updates per-group incumbents, expands octree children,
and merges them back — the hot loop never leaves the device.

Semantics parity per group with branch_and_bound_R3:
  * root node: center (0,0,0), half-span 1.0 (translation domain [-1,1]^3,
    fgoicp.cpp:113)
  * termination: best_error - min_lb < sse_threshold, or frontier empty
    (fgoicp.cpp:116-120)
  * nodes with lb >= best_error are discarded (fgoicp.cpp:127,151)
  * children inherit the parent's evaluated lb as queue priority
    (fgoicp.cpp:159-166); nodes below min_span are not split
    (fgoicp.cpp:155)
  * returns (best_ub = min ub seen, best_t = argmin-ub translation among
    improving nodes) (fgoicp.cpp:139-145,173)

Known deviation: a full frontier drops the worst-lb children instead of
growing (counted in `dropped`).  With default capacity this is rare, and
it can never silently void the optimality certificate: the minimum lb
ever dropped is tracked per group in `dropped_lb` and the consumer
(models/goicp.py) clamps the group's returned lower bound with it —
lb_sound = min(search result, dropped_lb[g]) — so a dropped min-lb
witness can only loosen the bound, not invalidate it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import bounds as bounds_ops
from . import geometry as geo

INVALID = jnp.float32(1e30)
BIG = jnp.float32(1e10)  # reference M_INF


class R3State(NamedTuple):
    centers: jnp.ndarray    # [G, C, 3]
    spans: jnp.ndarray      # [G, C]
    lbs: jnp.ndarray        # [G, C]  (INVALID marks an empty slot)
    best_err: jnp.ndarray   # [G] incumbent error for pruning
    best_ub: jnp.ndarray    # [G] min upper bound seen
    best_t: jnp.ndarray     # [G, 3]
    active: jnp.ndarray     # [G] bool
    steps: jnp.ndarray      # scalar int32
    evaluated: jnp.ndarray  # [G] int32 nodes evaluated (ref: count)
    dropped: jnp.ndarray    # [G] int32 children lost to capacity
    dropped_lb: jnp.ndarray  # [G] min lb ever dropped (INVALID = none)


def _sort_frontier(centers, spans, lbs, capacity):
    """Sort candidates ascending by lb and keep the best `capacity`.

    Also returns, per group, the count of valid nodes dropped and the
    minimum lb among them (INVALID when nothing was dropped) — the
    certificate-soundness witness (see module doc).
    """
    order = jnp.argsort(lbs, axis=-1)
    take = order[:, :capacity]
    lbs_s = jnp.take_along_axis(lbs, take, axis=-1)
    spans_s = jnp.take_along_axis(spans, take, axis=-1)
    centers_s = jnp.take_along_axis(centers, take[..., None], axis=-2)
    n_valid = jnp.sum(lbs < INVALID, axis=-1)
    dropped = jnp.maximum(n_valid - capacity, 0)
    rest_lb = jnp.take_along_axis(lbs, order[:, capacity:], axis=-1)
    drop_min = jnp.min(rest_lb, axis=-1)
    return centers_s, spans_s, lbs_s, dropped.astype(jnp.int32), drop_min


@functools.partial(jax.jit, static_argnames=(
    "batch", "capacity", "max_steps", "ref_compat_gamma", "trim_keep",
    "points_axis", "lockstep_axes", "trim_ns"))
def bnb_r3_batched(backend, pcs, R, rot_spans, fix_rot, best_sse,
                   sse_threshold, group_active=None, min_span=0.1,
                   batch: int = 32, capacity: int = 4096,
                   max_steps: int = 100000, ref_compat_gamma: bool = False,
                   trim_keep=None, points_axis=None, lockstep_axes=(),
                   point_weights=None, trim_ns=None):
    """Run G translation BnB searches in lockstep.

    backend: bounds backend (proxy/lut/exact); pcs: [ns, 3] source.
    R: [G, 3, 3]; rot_spans: [G]; fix_rot: [G] bool (True = gamma_r off).
    best_sse: scalar global incumbent; sse_threshold: convergence gap.
    Returns an R3State with final incumbents and counters.

    Sharding (used via parallel.bnb inside shard_map): `points_axis` names
    the mesh axis holding shards of `pcs` (bound sums psum over it);
    `lockstep_axes` names every mesh axis sharding the G (group) dimension
    — loop termination becomes a global vote so all shards iterate in
    lockstep with their collective partners.
    """
    R = jnp.asarray(R, jnp.float32)
    g = R.shape[0]
    if group_active is None:
        group_active = jnp.ones((g,), bool)

    centers0 = jnp.zeros((g, capacity, 3), jnp.float32)
    spans0 = jnp.zeros((g, capacity), jnp.float32).at[:, 0].set(1.0)
    lbs0 = jnp.full((g, capacity), INVALID, jnp.float32).at[:, 0].set(0.0)

    state0 = R3State(
        centers=centers0, spans=spans0, lbs=lbs0,
        best_err=jnp.full((g,), jnp.float32(best_sse)),
        best_ub=jnp.full((g,), BIG),
        best_t=jnp.zeros((g, 3), jnp.float32),
        active=jnp.asarray(group_active),
        steps=jnp.int32(0),
        evaluated=jnp.zeros((g,), jnp.int32),
        dropped=jnp.zeros((g,), jnp.int32),
        dropped_lb=jnp.full((g,), INVALID),
    )

    b = batch

    def cond(s: R3State):
        alive = jnp.sum(s.active.astype(jnp.int32))
        axes = tuple(lockstep_axes) + (
            (points_axis,) if points_axis is not None else ())
        if axes:
            alive = jax.lax.psum(alive, axes)
        return (alive > 0) & (s.steps < max_steps)

    def body(s: R3State) -> R3State:
        # Discard dominated nodes (ref pops-and-drops them, fgoicp.cpp:127).
        lbs = jnp.where(s.lbs < s.best_err[:, None], s.lbs, INVALID)
        top_lb = lbs[:, 0]
        empty = top_lb >= INVALID
        converged = (s.best_err - top_lb) < sse_threshold  # fgoicp.cpp:120
        active = s.active & ~(empty | converged)

        # Pop the best B nodes per group (frontier is sorted).
        cand_c = s.centers[:, :b]
        cand_s = s.spans[:, :b]
        cand_lb = lbs[:, :b]
        lane_valid = (cand_lb < INVALID) & active[:, None]

        lb_e, ub_e = bounds_ops.evaluate_bounds(
            backend, pcs, R, rot_spans, fix_rot, cand_c, cand_s,
            node_mask=lane_valid, ref_compat_gamma=ref_compat_gamma,
            trim_keep=trim_keep, points_axis=points_axis,
            point_weights=point_weights, trim_ns=trim_ns)

        # Incumbent update from the batch min ub (fgoicp.cpp:139-145).
        batch_min = jnp.min(ub_e, axis=-1)
        batch_arg = jnp.argmin(ub_e, axis=-1)
        best_ub = jnp.where(active, jnp.minimum(s.best_ub, batch_min), s.best_ub)
        improve = active & (batch_min < s.best_err)
        best_err = jnp.where(improve, batch_min, s.best_err)
        best_t = jnp.where(improve[:, None],
                           jnp.take_along_axis(
                               cand_c, batch_arg[:, None, None], axis=1)[:, 0],
                           s.best_t)

        # Spawn children for surviving, still-splittable nodes
        # (fgoicp.cpp:148-169).
        split = lane_valid & (lb_e < best_err[:, None]) & (cand_s >= min_span)
        ch_c, ch_s = geo.split_octree(cand_c, cand_s)      # [G, B, 8, 3]
        ch_lb = jnp.where(split[:, :, None], lb_e[:, :, None], INVALID)
        ch_c = ch_c.reshape(g, b * 8, 3)
        ch_s = ch_s.reshape(g, b * 8)
        ch_lb = jnp.broadcast_to(ch_lb, (g, b, 8)).reshape(g, b * 8)

        # Merge: remaining frontier + children, re-sort, truncate.
        rest_c = s.centers[:, b:]
        rest_s = s.spans[:, b:]
        rest_lb = lbs[:, b:]
        all_c = jnp.concatenate([rest_c, ch_c], axis=1)
        all_s = jnp.concatenate([rest_s, ch_s], axis=1)
        all_lb = jnp.concatenate([rest_lb, ch_lb], axis=1)
        new_c, new_s, new_lb, drop, drop_min = _sort_frontier(
            all_c, all_s, all_lb, capacity)
        dropped_lb = jnp.minimum(
            s.dropped_lb, jnp.where(active, drop_min, INVALID))

        # Freeze inactive groups.
        keep = ~active
        new_c = jnp.where(keep[:, None, None], s.centers, new_c)
        new_s = jnp.where(keep[:, None], s.spans, new_s)
        new_lb = jnp.where(keep[:, None], s.lbs, new_lb)

        return R3State(
            centers=new_c, spans=new_s, lbs=new_lb,
            best_err=best_err, best_ub=best_ub, best_t=best_t,
            active=active,
            steps=s.steps + 1,
            evaluated=s.evaluated + jnp.sum(lane_valid, axis=-1, dtype=jnp.int32),
            dropped=s.dropped + jnp.where(active, drop, 0),
            dropped_lb=dropped_lb,
        )

    s = jax.lax.while_loop(cond, body, state0)
    # Sound bound on a max_steps exit: fold the surviving frontier minimum
    # of still-active (unconverged) groups into dropped_lb — those nodes'
    # subtrees were never explored, so the group's search result alone is
    # not a valid lower bound (see pool_frontier for the same clamp).
    return s._replace(dropped_lb=jnp.where(
        s.active, jnp.minimum(s.dropped_lb, s.lbs[:, 0]), s.dropped_lb))
