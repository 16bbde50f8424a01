"""Search-state invariant sanitizer (SURVEY §5 sanitizer row).

The reference ships no sanitizers — its `cudaCheckError` is compiled out
by default (`fgoicp/common.hpp:15`, `fgoicp/common.cpp:7-21`) and CUDA
race tools were never wired in.  Here the hazard class is different:
XLA programs are functional, so data races don't exist, but the BnB's
correctness rests on SEARCH-STATE invariants that a kernel bug, an
unsound bound tweak, or a checkpoint/steal surgery slip can silently
break — and a broken invariant doesn't crash, it returns a confidently
wrong "global optimum".  This module is the sanitizer for that class:

* structural checks on the host heap and the device SO3State frontier,
* the bound-bracketing invariant lb <= ub on every live node,
* incumbent faithfulness: best_sse equals the exact (trimmed) SSE
  recomputed from (best_R, best_t) against the full clouds.

`engine.debug_checks = True` runs them at every host outer step and at
every device-state retrieval/chunk boundary (models/goicp.py), turning
silent corruption into an immediate SanitizeError naming the violated
invariant.  Cost: one extra exact-SSE evaluation per checked point —
strictly a debug mode, like the sanitizers it stands in for.
"""

from __future__ import annotations

import numpy as np


class SanitizeError(AssertionError):
    """A search-state invariant does not hold."""


def _fail(msg: str):
    raise SanitizeError(f"search-state invariant violated: {msg}")


def check_heap(heap, context: str = "outer heap") -> None:
    """Structural invariants of the host outer frontier.

    Entries are (lb, tie, (x, y, z, span, ub, tx, ty, tz)): bounds must
    be finite and non-negative with lb <= ub (ub may be the BIG sentinel
    for never-evaluated requeued children, models/goicp.py), spans
    positive and <= 1, and cube centers inside the root quaternion cube
    expanded by their span.
    """
    for lb, _tie, node in heap:
        x, y, z, span, ub = node[:5]
        if len(node) >= 8 and not all(np.isfinite(v) for v in node[5:8]):
            _fail(f"{context}: node translation {node[5:8]} not finite")
        if not np.isfinite(lb) or lb < 0.0:
            _fail(f"{context}: node lb {lb} not finite/non-negative")
        if lb > ub + 1e-6 * max(abs(ub), 1.0):
            _fail(f"{context}: node lb {lb} > ub {ub}")
        if not (0.0 < span <= 1.0):
            _fail(f"{context}: node span {span} outside (0, 1]")
        for c in (x, y, z):
            if abs(c) > 1.0 + span + 1e-6:
                _fail(f"{context}: cube center {(x, y, z)} outside the "
                      f"root quaternion cube (span {span})")


def check_device_state(st, context: str = "device SO3State") -> None:
    """Structural invariants of the device outer frontier (SO3State).

    The frontier arrays are lb-sorted ascending with an INVALID tail;
    live rows need positive spans and lb <= ub; counters are
    non-negative and consistent; the improvement-history ring is
    non-increasing in sse with hist_len <= capacity.
    """
    from ..ops import so3_frontier as so3

    lbs = np.asarray(st.lbs, np.float64)
    ubs = np.asarray(st.ubs, np.float64)
    spans = np.asarray(st.spans, np.float64)
    if np.any(np.diff(lbs) < -1e-6):
        _fail(f"{context}: frontier lbs not sorted ascending")
    live = lbs < float(so3.INVALID)
    if np.any(lbs[live] < 0.0):
        _fail(f"{context}: negative lb on a live node")
    if np.any(lbs[live] > ubs[live] + 1e-6 * np.maximum(
            np.abs(ubs[live]), 1.0)):
        _fail(f"{context}: lb > ub on a live node")
    if np.any(spans[live] <= 0.0) or np.any(spans[live] > 1.0 + 1e-6):
        _fail(f"{context}: live node span outside (0, 1]")
    for f in ("outer_steps", "nodes_expanded", "children_evaluated",
              "inner_nodes", "icp_runs", "icp_triggered", "pruned"):
        if int(getattr(st, f)) < 0:
            _fail(f"{context}: counter {f} negative")
    n_hist = int(st.hist_len)
    cap = int(np.asarray(st.hist_sse).shape[0])
    if not (0 <= n_hist <= cap):
        _fail(f"{context}: hist_len {n_hist} outside [0, {cap}]")
    hs = np.asarray(st.hist_sse, np.float64)[:n_hist]
    if np.any(np.diff(hs) > 1e-6 * np.maximum(np.abs(hs[:-1]), 1.0)):
        _fail(f"{context}: improvement history sse not non-increasing")
    if n_hist > 0 and float(st.best_sse) > hs[-1] + 1e-6 * max(
            abs(hs[-1]), 1.0):
        _fail(f"{context}: best_sse {float(st.best_sse)} above the last "
              f"recorded improvement {hs[-1]}")


def check_incumbent(model, context: str = "incumbent",
                    rtol: float = 5e-4, atol: float = 1e-6) -> None:
    """best_sse must equal the exact (trimmed) SSE recomputed from
    (best_rotation, best_translation) against the full normalized
    clouds — the invariant every prune decision rests on.  Skipped
    while no incumbent exists yet (best_sse at the BIG sentinel)."""
    from ..models import icp as icp_model
    from ..models.goicp import BIG

    if model.best_sse >= BIG:
        return
    sse = float(np.asarray(icp_model.exact_sse_batched(
        model.pct, model.pcs,
        np.asarray(model.best_rotation, np.float32)[None],
        np.asarray(model.best_translation, np.float32)[None],
        trim_keep=model.trim_keep))[0])
    if abs(sse - model.best_sse) > rtol * max(abs(sse), 1.0) + atol:
        _fail(f"{context}: best_sse {model.best_sse} != exact SSE "
              f"{sse} recomputed at (best_R, best_t)")
