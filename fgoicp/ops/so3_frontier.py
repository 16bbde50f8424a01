"""Fully on-device nested Go-ICP BnB: the outer SO(3) loop as a device
frontier (2-level frontier, opt-in via EngineConfig.outer_mode="device").

The default engine keeps the outer loop on host (models/goicp.py): a
host heap is cheap at the usual 5-10 outer steps and supports
checkpoint/resume, incumbent history, and multi-host partitioning.  But
every outer step pays a fixed device-call cost (dispatch, argument
staging and readback), which dominates hard searches that take tens to
hundreds of outer steps.  This module moves
the ENTIRE nested search — outer SO(3) octree, inner R^3 pooled BnB,
and the batched ICP refinements — into ONE jitted lax.while_loop, so a
full registration is a single device call regardless of outer depth.

Semantics parity with the host loop (and thus with the reference,
/root/reference/fgoicp/fgoicp.cpp:32-100):
  * best-first pop of `rotation_batch` cubes per outer iteration;
  * octree split, min-span cutoff (children below rotation_min_span are
    dropped WITH their parent, fgoicp.cpp:53 — but unlike the
    reference, a popped terminal leaf still CLAIMING improvement gets
    a priority ICP lane before closing, and every closed leaf's lb
    folds into closed_lb so exhaustion cannot fake a certificate);
  * SO(3) membership tests: children overlapping-but-outside re-enter
    the frontier with the parent's lb, unevaluated (reference quirk,
    fgoicp.cpp:61-66); non-overlapping children are discarded;
  * inner pooled BnB evaluates ub (fix_rot) and lb passes for all
    in-SO(3) children of the batch in one shared pool, with twin
    incumbent sharing and hierarchical source clusters when configured;
  * lane-filled ICP refinement: the icp_width lowest-ub children
    refine each outer iteration (a superset of the reference's 1.8x
    trigger, models/goicp.py:_refine_candidates rationale), iterating
    on the proxy coreset with an exact full-target re-score when
    enabled;
  * pruning lb >= best_sse (fgoicp.cpp:92) and gap termination
    best_sse - min_lb <= sse_threshold (fgoicp.cpp:44-47).

Certificate under capacity overflow: the SO(3) frontier is
fixed-capacity and — unlike the inner pools, whose dropped nodes live
on as re-expandable rotation children — a subtree dropped here is gone
for good.  The minimum lb ever dropped is therefore folded into the
TERMINATION GAP (the loop cannot claim convergence past it), and the
caller must check `certified_gap(state) <= sse_threshold` on exit: an
open gap (capacity overflow bound it, or max_outer truncated the
search) means the result is an incumbent WITHOUT a certificate.
models/goicp.py reacts by logging a warning and re-certifying with the
host loop, which inherits the (usually excellent) device incumbent and
prunes fast.

Device-mode ICP refinement intentionally deviates from the host
scheduler in one bounded way: at most `icp_width` children refine per
outer step (the host chunks through every triggered child).  With
icp_refine_best the width is filled with the lowest-ub children; with
it off, only triggered children among those lanes run.

Not supported in device mode (use the host loop): multi-host
partitioning.  Per-improvement incumbent history IS recorded
(fixed-capacity ring in SO3State, read back by models/goicp.py), and
checkpoint/resume IS supported: `init_state` + traced `max_outer` let
models/goicp.py run the search in fixed-step chunks, persisting the
SO3State pytree between device calls.  Mesh sharding IS supported on
BOTH axes via parallel.bnb.so3_bnb_device_sharded:

* POINT axis: pct/search_pcs shard; bound sums psum, ICP
  correspondences pmin-vote (see so3_bnb_device docstring).
* CUBE axis (`cubes_axis`/`n_cubes`): the SO(3) frontier is REPLICATED
  — every shard runs the identical pop/split/merge computation on
  collectively-identical values — while the expensive work is SLICED:
  each outer step pops rotation_batch * n_cubes cubes, shard i runs the
  inner pooled BnB for its 8*rotation_batch-child slice and its
  icp_width/n_cubes ICP lanes, and the tiny per-child results
  (ub, lb, t — ~5 floats/child) all-gather across devices before the
  replicated frontier update.  This sidesteps the partitioned-frontier
  load-balance problem entirely (every shard gets exactly 1/n of every
  step's children) and keeps the certificate machinery identical to
  single-device.  An (n_cubes, rotation_batch=rb) run explores the same
  outer octree as a single-device run with rotation_batch = n*rb; the
  per-child bounds may differ within the inner termination gap (each
  shard's pool schedules only its own slice, so the pop order differs
  from one big shared pool — same gap-certified optima, different node
  counts, exactly like pooled-vs-grouped scheduling).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from . import geometry as geo
from . import pool_frontier
from ..models import icp as icp_model

INVALID = jnp.float32(1e30)
BIG = jnp.float32(1e10)


class SO3State(NamedTuple):
    lbs: jnp.ndarray       # [C] (INVALID = empty slot)
    ubs: jnp.ndarray       # [C] stored child ub (observability only)
    coords: jnp.ndarray    # [C, 3] quaternion-cube centers
    spans: jnp.ndarray     # [C] half-spans
    ts: jnp.ndarray        # [C, 3] inner-BnB best translation per node
    #                        (ICP start for terminal-leaf claim refines)
    best_sse: jnp.ndarray  # scalar incumbent
    best_R: jnp.ndarray    # [3, 3]
    best_t: jnp.ndarray    # [3]
    dropped_lb: jnp.ndarray   # scalar: min lb lost to frontier overflow
    closed_lb: jnp.ndarray    # scalar: min lb of CLOSED terminal leaves
    #   (span below rotation_min_span, subtree discarded — fgoicp.cpp:53).
    #   Folded into certified_gap but NOT the loop condition: a leaf
    #   cannot be expanded, so holding the loop open on it would never
    #   terminate; the caller's re-certification fallback (goicp.py)
    #   decides.  Without this fold, frontier exhaustion with discarded
    #   claim leaves looked like a closed certificate (measured: the
    #   trimmed bun000/bun090 pair returned a wrong 'global' optimum
    #   7.7x above the true one).
    outer_steps: jnp.ndarray
    nodes_expanded: jnp.ndarray     # splittable cubes actually popped
    children_evaluated: jnp.ndarray
    inner_nodes: jnp.ndarray
    icp_runs: jnp.ndarray           # ICP lanes executed
    icp_triggered: jnp.ndarray      # children passing the 1.8x trigger
    pruned: jnp.ndarray
    # Incumbent-improvement history ring (observability parity with the
    # host loop's per-improvement history, models/goicp.py).  Fixed
    # capacity H = history_capacity; if improvements exceed H the LAST
    # slot keeps being overwritten, so the final incumbent is always
    # recorded.  hist_len counts recorded entries (saturates at H).
    hist_sse: jnp.ndarray   # [H]
    hist_R: jnp.ndarray     # [H, 3, 3]
    hist_t: jnp.ndarray     # [H, 3]
    hist_step: jnp.ndarray  # [H] outer step index of each improvement
    hist_len: jnp.ndarray   # scalar int32


def initial_state(capacity: int, history_capacity: int = 32,
                  best_sse=BIG, best_R=None, best_t=None,
                  cells=None) -> SO3State:
    """Fresh SO3State as HOST (numpy-backed) arrays.

    cells: optional [(x, y, z, half_span), ...] seed frontier replacing
    the default full quaternion cube (fgoicp.cpp:36) — used by
    multi-host partition seeding, where each process searches its own
    sub-cubes.  Seed lbs are 0 (the root knows nothing yet).

    Host construction keeps the per-leaf device transfers to ONE staging
    pass when the state is fed to so3_bnb_device(init_state=...) —
    each eager device op is a separate dispatch and transfer.
    """
    import numpy as _np
    cap, hc = capacity, history_capacity
    lbs = _np.full((cap,), float(INVALID), _np.float32)
    coords = _np.zeros((cap, 3), _np.float32)
    spans = _np.zeros((cap,), _np.float32)
    if cells is None:
        cells = [(0.0, 0.0, 0.0, 1.0)]
    if len(cells) > cap:
        raise ValueError(f"{len(cells)} seed cells > capacity {cap}")
    for i, (x, y, z, span) in enumerate(cells):
        lbs[i] = 0.0
        coords[i] = (x, y, z)
        spans[i] = span
    return SO3State(
        lbs=lbs, ubs=_np.full((cap,), float(BIG), _np.float32),
        coords=coords, spans=spans,
        ts=_np.zeros((cap, 3), _np.float32),
        best_sse=_np.float32(best_sse),
        best_R=_np.asarray(
            _np.eye(3) if best_R is None else best_R, _np.float32),
        best_t=_np.asarray(
            _np.zeros(3) if best_t is None else best_t, _np.float32),
        dropped_lb=_np.float32(INVALID),
        closed_lb=_np.float32(INVALID),
        outer_steps=_np.int32(0), nodes_expanded=_np.int32(0),
        children_evaluated=_np.int32(0), inner_nodes=_np.int32(0),
        icp_runs=_np.int32(0), icp_triggered=_np.int32(0),
        pruned=_np.int32(0),
        hist_sse=_np.full((hc,), float(BIG), _np.float32),
        hist_R=_np.zeros((hc, 3, 3), _np.float32),
        hist_t=_np.zeros((hc, 3), _np.float32),
        hist_step=_np.zeros((hc,), _np.int32),
        hist_len=_np.int32(0))


def state_from_arrays(arrays: dict) -> SO3State:
    """Build an SO3State from a checkpoint's field->array dict.

    Fields added after the checkpoint was written get SOUND defaults
    (ts=0 — leaf refines start from the cube origin; closed_lb=INVALID
    — no leaf had been closed when older code wrote the state), so
    pre-r5 device checkpoints keep loading instead of raising KeyError.
    """
    import numpy as _np
    a = dict(arrays)
    cap = _np.asarray(a["lbs"]).shape[0]
    a.setdefault("ts", _np.zeros((cap, 3), _np.float32))
    a.setdefault("closed_lb", _np.float32(INVALID))
    return SO3State(**{f: a[f] for f in SO3State._fields})


def merge_states(states) -> SO3State:
    """Merge several SO3States — one per host of a partitioned run —
    into one HOST (numpy) state for elastic recovery
    (models/goicp.py:load_checkpoints).

    The multi-host partition keeps every unexplored subtree in exactly
    one host's frontier, so the UNION of the frontiers plus the min-sse
    incumbent re-covers the entire not-yet-pruned region.  Rows past
    the shared capacity spill into the dropped_lb certificate clamp
    (same rule as the device loop's own overflow).  Counters sum (the
    merged state carries the work all hosts did) — consumers of
    outer_steps as a step BUDGET must therefore anchor their valve
    relative to the resumed value (models/goicp.py does), never as an
    absolute cap.  The improvement ring of the incumbent-owning state
    is kept (rings are per-host observability, not search state).
    """
    import numpy as _np
    cap = states[0].lbs.shape[0]
    hc = states[0].hist_sse.shape[0]
    for s in states[1:]:
        if s.lbs.shape[0] != cap or s.hist_sse.shape[0] != hc:
            raise ValueError(
                "cannot merge SO3States with different capacities")
    lbs = _np.concatenate([_np.asarray(s.lbs) for s in states])
    ubs = _np.concatenate([_np.asarray(s.ubs) for s in states])
    coords = _np.concatenate([_np.asarray(s.coords) for s in states])
    spans = _np.concatenate([_np.asarray(s.spans) for s in states])
    ts = _np.concatenate([_np.asarray(s.ts) for s in states])
    order = _np.argsort(lbs, kind="stable")
    dropped = min(float(s.dropped_lb) for s in states)
    spill = lbs[order[cap:]]
    spill = spill[spill < float(INVALID)]
    if spill.size:
        dropped = min(dropped, float(spill.min()))
    order = order[:cap]
    k = int(_np.argmin([float(s.best_sse) for s in states]))
    best = states[k]

    def tot(f):
        return _np.int32(sum(int(getattr(s, f)) for s in states))

    return SO3State(
        lbs=_np.asarray(lbs[order], _np.float32),
        ubs=_np.asarray(ubs[order], _np.float32),
        coords=_np.asarray(coords[order], _np.float32),
        spans=_np.asarray(spans[order], _np.float32),
        ts=_np.asarray(ts[order], _np.float32),
        best_sse=_np.float32(best.best_sse),
        best_R=_np.asarray(best.best_R, _np.float32),
        best_t=_np.asarray(best.best_t, _np.float32),
        dropped_lb=_np.float32(dropped),
        closed_lb=_np.float32(
            min(float(s.closed_lb) for s in states)),
        outer_steps=tot("outer_steps"),
        nodes_expanded=tot("nodes_expanded"),
        children_evaluated=tot("children_evaluated"),
        inner_nodes=tot("inner_nodes"), icp_runs=tot("icp_runs"),
        icp_triggered=tot("icp_triggered"), pruned=tot("pruned"),
        hist_sse=_np.asarray(best.hist_sse, _np.float32),
        hist_R=_np.asarray(best.hist_R, _np.float32),
        hist_t=_np.asarray(best.hist_t, _np.float32),
        hist_step=_np.asarray(best.hist_step, _np.int32),
        hist_len=_np.int32(best.hist_len))


def certified_gap(s: SO3State):
    """Optimality gap the final state actually certifies: incumbent
    minus the lowest lower bound anywhere — the frontier minimum or a
    subtree lost to capacity overflow, whichever is lower.  A value
    <= sse_threshold means certified optimal; anything larger means the
    device search ended (overflow-bound or max_outer-truncated) without
    a certificate and the caller must re-certify.

    closed_lb folds in terminal leaves discarded at rotation_min_span
    (SO3State doc): their subtrees were closed after at most one
    leaf-claim ICP refine, so only the incumbent can vouch for them."""
    floor = jnp.minimum(jnp.minimum(s.lbs[0], s.dropped_lb), s.closed_lb)
    # An empty frontier with no drops certifies exhaustively: make that
    # explicit rather than relying on sentinel arithmetic (INVALID floor
    # would make the gap hugely negative either way, but an explicit
    # branch survives refactors of the sentinel values).
    return jnp.where(floor >= INVALID, -BIG, s.best_sse - floor)


@functools.partial(jax.jit, static_argnames=(
    "rotation_batch", "capacity", "rotation_min_span",
    "translation_min_span", "pool_lanes", "pool_capacity",
    "ref_compat_gamma", "icp_width", "icp_max_iter", "trim_keep",
    "points_axis", "trim_ns", "icp_refine_best", "cubes_axis", "n_cubes",
    "history_capacity", "icp_search_trim", "pool_update"))
def so3_bnb_device(backend, pct, pcs, search_pcs, best_sse0, best_R0,
                   best_t0, sse_threshold,
                   point_weights=None, point_deltas=None,
                   rotation_batch: int = 16, capacity: int = 16384,
                   max_outer: int = 10000,
                   rotation_min_span: float = 0.05,
                   translation_min_span: float = 0.1,
                   pool_lanes: int = 1024, pool_capacity: int = 32768,
                   ref_compat_gamma: bool = False,
                   icp_width: int = 16, icp_max_iter: int = 100,
                   icp_convergence=0.005,
                   icp_trigger_factor=1.8,
                   icp_search_target=None,
                   icp_search_src=None,
                   icp_search_trim: Optional[int] = None,
                   trim_keep: Optional[int] = None,
                   points_axis=None, target_offset=None,
                   trim_ns: Optional[int] = None,
                   icp_refine_best: bool = True,
                   cubes_axis=None, n_cubes: int = 1,
                   history_capacity: int = 32,
                   init_state: Optional[SO3State] = None,
                   pool_update: str = "sort") -> SO3State:
    """Run the whole nested BnB on device; returns the final SO3State.

    pct: [nt, 3] full target (exact ICP scoring); pcs: [ns, 3] full
    source; search_pcs: bound-evaluation source (cluster reps or pcs).
    best_*: incumbent seed (from the host-side initial ICP).
    icp_search_target: optional smaller ICP iteration target (proxy
    coreset); the final pose is exactly re-scored on pct either way.

    Point sharding (parallel.bnb.so3_bnb_device_sharded): `points_axis`
    names the mesh axis over which pct/search_pcs (and point_weights/
    point_deltas) hold this device's shards — bound sums psum, ICP
    correspondences and exact SSE use the pmin vote with
    `target_offset` as this shard's global row offset.  The SO(3)
    frontier itself is replicated: every shard runs the identical outer
    computation on collectively-identical values.

    Resumable: `init_state` (an SO3State from a previous call, a
    checkpoint, or initial_state()) continues the search in place of a
    fresh root frontier; `max_outer` is TRACED (no recompile per value)
    and compares against the ABSOLUTE outer_steps counter, so a chunked
    driver passes `int(state.outer_steps) + chunk` to run `chunk` more
    steps.  best_sse0/R0/t0 are ignored when init_state is given (the
    state carries its own incumbent).
    """
    if (cubes_axis is None) != (n_cubes == 1):
        raise ValueError("cubes_axis and n_cubes must be set together")
    b = rotation_batch * n_cubes   # total cubes popped per outer step
    g = b * 8                      # total children per outer step
    g_loc = rotation_batch * 8     # children evaluated on THIS shard
    cap = capacity
    if cap < 8 * b:
        raise ValueError(
            f"so3 capacity {cap} cannot hold one batch's children "
            f"(8 * rotation_batch * n_cubes = {8 * b}); raise so3_capacity")
    # ICP lanes slice evenly over cube shards: round the width up to a
    # multiple of n_cubes (g is always such a multiple).
    w_icp = min(icp_width, g)
    w_icp = min(-(-w_icp // n_cubes) * n_cubes, g)
    w_loc = w_icp // n_cubes
    share = jnp.concatenate([jnp.full((g_loc,), -1, jnp.int32),
                             jnp.arange(g_loc, dtype=jnp.int32)])

    if init_state is None:
        state0 = SO3State(
            lbs=jnp.full((cap,), INVALID).at[0].set(0.0),
            ubs=jnp.full((cap,), BIG),
            coords=jnp.zeros((cap, 3), jnp.float32),
            spans=jnp.zeros((cap,), jnp.float32).at[0].set(1.0),
            ts=jnp.zeros((cap, 3), jnp.float32),
            best_sse=jnp.float32(best_sse0),
            best_R=jnp.asarray(best_R0, jnp.float32),
            best_t=jnp.asarray(best_t0, jnp.float32),
            dropped_lb=INVALID,
            closed_lb=INVALID,
            outer_steps=jnp.int32(0),
            nodes_expanded=jnp.int32(0),
            children_evaluated=jnp.int32(0),
            inner_nodes=jnp.int32(0),
            icp_runs=jnp.int32(0),
            icp_triggered=jnp.int32(0),
            pruned=jnp.int32(0),
            hist_sse=jnp.full((history_capacity,), BIG),
            hist_R=jnp.zeros((history_capacity, 3, 3), jnp.float32),
            hist_t=jnp.zeros((history_capacity, 3), jnp.float32),
            hist_step=jnp.zeros((history_capacity,), jnp.int32),
            hist_len=jnp.int32(0),
        )
    else:
        if init_state.lbs.shape[0] != cap or \
                init_state.hist_sse.shape[0] != history_capacity:
            raise ValueError(
                f"init_state shapes (capacity {init_state.lbs.shape[0]}, "
                f"history {init_state.hist_sse.shape[0]}) do not match "
                f"so3_capacity={cap} / history_capacity={history_capacity}")
        state0 = jax.tree.map(jnp.asarray, init_state)
    max_outer = jnp.int32(max_outer)

    def cond(s: SO3State):
        # Gate on the REACHABLE frontier floor only: once a capacity
        # overflow drops a subtree, its dropped_lb holds the CERTIFICATE
        # gap open permanently (certified_gap folds it in), but keeping
        # it out of the loop condition lets an overflowed search still
        # stop as soon as the nodes it can actually expand are within
        # the gap — instead of draining the whole frontier before the
        # host re-certification fallback starts.
        open_gap = (s.best_sse - s.lbs[0]) > sse_threshold
        return open_gap & (s.lbs[0] < INVALID) & (s.outer_steps < max_outer)

    def body(s: SO3State) -> SO3State:
        # ---- pop the best B cubes and split (fgoicp.cpp:50-66) ----
        p_lb = s.lbs[:b]
        p_c = s.coords[:b]
        p_s = s.spans[:b]
        p_t = s.ts[:b]
        p_valid = p_lb < INVALID
        ch_span = p_s / 2.0
        splittable = p_valid & (ch_span >= rotation_min_span)
        # Terminal leaves: popped nodes whose children would fall below
        # rotation_min_span (fgoicp.cpp:53) — their subtree closes this
        # step.  Ones whose lb still CLAIMS an improvement beyond the
        # termination slack get priority ICP lanes below (the host
        # analog is goicp._refine_candidates' leaf-claim trigger);
        # claims that cannot be given a lane this step are requeued
        # unchanged so no claim subtree is ever closed unrefined.
        terminal = p_valid & ~splittable
        term_claim = terminal & (p_lb < s.best_sse - sse_threshold)

        ch_c, ch_s = geo.split_octree(p_c, p_s)               # [B, 8, 3]
        overlaps = geo.overlaps_so3(ch_c, ch_s)
        inside = geo.in_so3(ch_c)
        eval_mask = (splittable[:, None] & overlaps & inside).reshape(g)
        requeue_mask = (splittable[:, None] & overlaps
                        & ~inside).reshape(g)
        ch_c = ch_c.reshape(g, 3)
        ch_s = ch_s.reshape(g)
        parent_lb = jnp.broadcast_to(p_lb[:, None], (b, 8)).reshape(g)

        # ---- inner R^3 BnB: ub pass + lb pass in one shared pool ----
        # Under cube-axis sharding each shard evaluates only its
        # g_loc-child slice; the tiny per-child results all-gather back
        # so the (replicated) frontier update below stays identical on
        # every shard.
        R = geo.quat_cube_to_matrix(ch_c)
        if cubes_axis is None:
            sl = lambda a: a
        else:
            start = (jax.lax.axis_index(cubes_axis).astype(jnp.int32)
                     * g_loc)
            sl = lambda a: jax.lax.dynamic_slice_in_dim(a, start, g_loc, 0)
        R_l, ch_s_l, eval_l = sl(R), sl(ch_s), sl(eval_mask)
        R2 = jnp.concatenate([R_l, R_l])
        spans2 = jnp.concatenate([ch_s_l, ch_s_l])
        fix2 = jnp.concatenate([jnp.ones((g_loc,), bool),
                                jnp.zeros((g_loc,), bool)])
        act2 = jnp.concatenate([eval_l, eval_l])
        st = pool_frontier.bnb_r3_pooled(
            backend, search_pcs, R2, spans2, fix2, s.best_sse,
            sse_threshold, group_active=act2,
            min_span=translation_min_span, lanes=pool_lanes,
            capacity=pool_capacity, ref_compat_gamma=ref_compat_gamma,
            trim_keep=trim_keep, point_weights=point_weights,
            point_deltas=point_deltas, err_share_from=share,
            points_axis=points_axis, trim_ns=trim_ns,
            lockstep_axes=(() if cubes_axis is None else (cubes_axis,)),
            pool_update=pool_update)
        ub_l = jnp.where(eval_l, st.best_ub[:g_loc], BIG)
        t_l = st.best_t[:g_loc]
        lb_l = jnp.minimum(
            jnp.minimum(st.best_ub[g_loc:], st.best_err[g_loc:]),
            st.dropped_lb[g_loc:])
        inner_ev = jnp.sum(st.evaluated, dtype=jnp.int32)
        if cubes_axis is None:
            ub, t_g, lb_g = ub_l, t_l, lb_l
        else:
            ub = jax.lax.all_gather(ub_l, cubes_axis, tiled=True)
            t_g = jax.lax.all_gather(t_l, cubes_axis, tiled=True)
            lb_g = jax.lax.all_gather(lb_l, cubes_axis, tiled=True)
            inner_ev = jax.lax.psum(inner_ev, cubes_axis)

        # ---- lane-filled ICP refinement (goicp._refine_candidates;
        # bounded at w_icp lanes per step, module doc).  Under cube-axis
        # sharding the top-k selection is computed identically on every
        # shard (replicated `ub`); each shard refines its w_loc-lane
        # slice and the pose results all-gather back.
        # Candidates = popped terminal-leaf claims (ranked FIRST,
        # regardless of ub: the inner translation min_span floors leaf
        # ubs far above the achievable SSE, so ub-ranked selection
        # starves exactly the basins the certificate still owes) then
        # this step's children by lowest ub. ----
        cand_R = jnp.concatenate([geo.quat_cube_to_matrix(p_c), R])
        cand_t = jnp.concatenate([p_t, t_g])
        leaf_key = jnp.where(term_claim, p_lb - BIG, BIG)       # [B]
        child_key = jnp.where(eval_mask, ub, BIG)               # [G]
        key = jnp.concatenate([leaf_key, child_key])            # [B+G]
        _, sel = jax.lax.top_k(-key, w_icp)
        trig_all = jnp.concatenate([
            term_claim,
            eval_mask & (ub < s.best_sse
                         * jnp.float32(icp_trigger_factor))])
        trig = trig_all[sel]
        sel_ok = (key[sel] < BIG) if icp_refine_best else trig
        got_lane = jnp.zeros((b + g,), bool).at[sel].set(sel_ok)
        if cubes_axis is None:
            sel_l, ok_l = sel, sel_ok
        else:
            w_start = (jax.lax.axis_index(cubes_axis).astype(jnp.int32)
                       * w_loc)
            sel_l = jax.lax.dynamic_slice_in_dim(sel, w_start, w_loc, 0)
            ok_l = jax.lax.dynamic_slice_in_dim(sel_ok, w_start, w_loc, 0)
        if icp_search_target is None:
            # Iterate directly on the (possibly sharded) full target.
            sse_i, R_i, t_i = icp_model.icp_batched(
                pct, pcs, cand_R[sel_l], cand_t[sel_l], active=ok_l,
                max_iter=icp_max_iter,
                convergence_threshold=icp_convergence,
                trim_keep=trim_keep, target_axis=points_axis,
                target_offset=target_offset)
        else:
            # Iterate on the (replicated) proxy coreset — and on the
            # source subsample when one is configured (icp_search_src /
            # icp_search_trim, config.icp_search_subsample) — then
            # re-score exactly on the full clouds, possibly sharded.
            it_src = pcs if icp_search_src is None else icp_search_src
            it_trim = trim_keep if icp_search_src is None \
                else icp_search_trim
            _, R_i, t_i = icp_model.icp_batched(
                icp_search_target, it_src, cand_R[sel_l], cand_t[sel_l],
                active=ok_l, max_iter=icp_max_iter,
                convergence_threshold=icp_convergence,
                trim_keep=it_trim)
            sse_i = icp_model.exact_sse_batched(
                pct, pcs, R_i, t_i, trim_keep=trim_keep,
                target_axis=points_axis)
        if cubes_axis is not None:
            sse_i = jax.lax.all_gather(sse_i, cubes_axis, tiled=True)
            R_i = jax.lax.all_gather(R_i, cubes_axis, tiled=True)
            t_i = jax.lax.all_gather(t_i, cubes_axis, tiled=True)
        sse_i = jnp.where(sel_ok, sse_i, BIG)
        k = jnp.argmin(sse_i)
        improve = sse_i[k] < s.best_sse
        best_sse = jnp.where(improve, sse_i[k], s.best_sse)
        best_R = jnp.where(improve, R_i[k], s.best_R)
        best_t = jnp.where(improve, t_i[k], s.best_t)

        # ---- incumbent history ring (SO3State doc) ----
        hidx = jnp.minimum(s.hist_len, history_capacity - 1)
        hist_sse = s.hist_sse.at[hidx].set(
            jnp.where(improve, best_sse, s.hist_sse[hidx]))
        hist_R = s.hist_R.at[hidx].set(
            jnp.where(improve, best_R, s.hist_R[hidx]))
        hist_t = s.hist_t.at[hidx].set(
            jnp.where(improve, best_t, s.hist_t[hidx]))
        hist_step = s.hist_step.at[hidx].set(
            jnp.where(improve, s.outer_steps + 1, s.hist_step[hidx]))
        hist_len = jnp.minimum(s.hist_len + improve.astype(jnp.int32),
                               history_capacity)

        # ---- prune + push children (fgoicp.cpp:92-96) ----
        keep_eval = eval_mask & (lb_g < best_sse)
        ch_lb = jnp.where(keep_eval, lb_g,
                          jnp.where(requeue_mask, parent_lb, INVALID))
        ch_ub = jnp.where(keep_eval, ub, BIG)
        # Requeued outside-SO(3) children inherit the PARENT's inner
        # translation along with its lb — their eventual terminal-leaf
        # claim refine must not start from t=0 on translated pairs.
        parent_t = jnp.broadcast_to(p_t[:, None, :], (b, 8, 3)) \
            .reshape(g, 3)
        ch_t = jnp.where(keep_eval[:, None], t_g,
                         jnp.where(requeue_mask[:, None], parent_t, 0.0))
        # Terminal-claim leaves that could not get an ICP lane this step
        # (and still claim vs the UPDATED incumbent) requeue unchanged;
        # every other popped terminal leaf closes now and folds its lb
        # into closed_lb (certified_gap doc).
        requeue_self = term_claim & ~got_lane[:b] \
            & (p_lb < best_sse - sse_threshold)
        self_lb = jnp.where(requeue_self, p_lb, INVALID)
        self_ub = jnp.where(requeue_self, s.ubs[:b], BIG)
        closed_now = jnp.where(terminal & ~requeue_self, p_lb, INVALID)
        closed_lb = jnp.minimum(s.closed_lb, jnp.min(closed_now))
        all_lb = jnp.concatenate([s.lbs[b:], ch_lb, self_lb])
        all_ub = jnp.concatenate([s.ubs[b:], ch_ub, self_ub])
        all_c = jnp.concatenate([s.coords[b:], ch_c, p_c])
        all_s = jnp.concatenate([s.spans[b:], ch_s, p_s])
        all_t = jnp.concatenate([s.ts[b:], ch_t, p_t])
        order = jnp.argsort(all_lb)
        new_lb = all_lb[order[:cap]]
        rest_lb = all_lb[order[cap:]]
        dropped_lb = jnp.minimum(s.dropped_lb, jnp.min(rest_lb))

        return SO3State(
            lbs=new_lb, ubs=all_ub[order[:cap]],
            coords=all_c[order[:cap]], spans=all_s[order[:cap]],
            ts=all_t[order[:cap]],
            best_sse=best_sse, best_R=best_R, best_t=best_t,
            dropped_lb=dropped_lb, closed_lb=closed_lb,
            outer_steps=s.outer_steps + 1,
            nodes_expanded=s.nodes_expanded
            + jnp.sum(splittable, dtype=jnp.int32),
            children_evaluated=s.children_evaluated
            + jnp.sum(eval_mask, dtype=jnp.int32),
            inner_nodes=s.inner_nodes + inner_ev,
            icp_runs=s.icp_runs + jnp.sum(sel_ok, dtype=jnp.int32),
            icp_triggered=s.icp_triggered
            + jnp.sum(trig & sel_ok, dtype=jnp.int32),
            pruned=s.pruned + jnp.sum(eval_mask & (lb_g >= best_sse),
                                      dtype=jnp.int32),
            hist_sse=hist_sse, hist_R=hist_R, hist_t=hist_t,
            hist_step=hist_step, hist_len=hist_len,
        )

    return jax.lax.while_loop(cond, body, state0)
