"""Unit tests for the device SO(3) frontier's certificate arithmetic.

End-to-end device-mode coverage lives in test_goicp.py / test_parallel.py;
these pin the certified_gap edge cases (the empty-frontier convention
must be explicit, not sentinel arithmetic)."""
import jax.numpy as jnp
import numpy as np

from fgoicp.ops import so3_frontier as so3


def _state(lbs0, dropped_lb, best_sse=1.0, cap=8, hist=4,
           closed_lb=float(so3.INVALID)):
    lbs = jnp.full((cap,), so3.INVALID).at[0].set(jnp.float32(lbs0))
    return so3.SO3State(
        lbs=lbs, ubs=jnp.full((cap,), so3.BIG),
        coords=jnp.zeros((cap, 3), jnp.float32),
        spans=jnp.zeros((cap,), jnp.float32),
        ts=jnp.zeros((cap, 3), jnp.float32),
        best_sse=jnp.float32(best_sse), best_R=jnp.eye(3, dtype=jnp.float32),
        best_t=jnp.zeros((3,), jnp.float32),
        dropped_lb=jnp.float32(dropped_lb),
        closed_lb=jnp.float32(closed_lb),
        outer_steps=jnp.int32(0), nodes_expanded=jnp.int32(0),
        children_evaluated=jnp.int32(0), inner_nodes=jnp.int32(0),
        icp_runs=jnp.int32(0), icp_triggered=jnp.int32(0),
        pruned=jnp.int32(0),
        hist_sse=jnp.full((hist,), so3.BIG),
        hist_R=jnp.zeros((hist, 3, 3), jnp.float32),
        hist_t=jnp.zeros((hist, 3), jnp.float32),
        hist_step=jnp.zeros((hist,), jnp.int32),
        hist_len=jnp.int32(0))


def test_merge_states_union_and_spill():
    """merge_states (elastic recovery): union of live rows lb-sorted,
    min-sse incumbent adopted, capacity spill folded into dropped_lb,
    counters summed."""
    R1 = np.eye(3, dtype=np.float32)
    a = so3.initial_state(8, best_sse=2.0,
                          cells=[(0.5, 0.5, 0.5, 0.5)])
    a = a._replace(outer_steps=np.int32(3))
    b = so3.initial_state(8, best_sse=1.0, best_R=R1,
                          best_t=np.array([1, 2, 3], np.float32),
                          cells=[(-0.5, -0.5, -0.5, 0.5),
                                 (0.5, -0.5, 0.5, 0.5)])
    b = b._replace(outer_steps=np.int32(4))
    m = so3.merge_states([a, b])
    assert float(m.best_sse) == 1.0
    np.testing.assert_array_equal(m.best_t, [1, 2, 3])
    assert int(np.sum(np.asarray(m.lbs) < so3.INVALID)) == 3
    assert int(m.outer_steps) == 7
    assert float(m.dropped_lb) >= so3.INVALID  # no spill at cap 8

    # Overflow: two full cap-2 frontiers merge into cap 2 -> 2 rows
    # spill; their min lb (0.0) must clamp dropped_lb.
    cells2 = [(0.5, 0.5, 0.5, 0.5), (-0.5, 0.5, 0.5, 0.5)]
    c = so3.initial_state(2, best_sse=5.0, cells=cells2)
    d = so3.initial_state(2, best_sse=6.0, cells=cells2)
    md = so3.merge_states([c, d])
    assert float(md.dropped_lb) == 0.0


def test_certified_gap_exhausted_frontier_certifies():
    """Empty frontier + no drops = the search explored everything: the
    gap must be decisively negative (certified), via the explicit
    empty-floor branch rather than sentinel subtraction."""
    s = _state(float(so3.INVALID), float(so3.INVALID), best_sse=0.5)
    gap = float(so3.certified_gap(s))
    assert gap <= -1e9


def test_certified_gap_exhausted_but_dropped_stays_open():
    """Empty frontier but a subtree was dropped at lb=0.2 with incumbent
    1.0: the gap is exactly best_sse - dropped_lb and stays open."""
    s = _state(float(so3.INVALID), 0.2, best_sse=1.0)
    np.testing.assert_allclose(float(so3.certified_gap(s)), 0.8, rtol=1e-6)


def test_certified_gap_uses_frontier_floor():
    s = _state(0.3, float(so3.INVALID), best_sse=1.0)
    np.testing.assert_allclose(float(so3.certified_gap(s)), 0.7, rtol=1e-6)


def test_certified_gap_min_of_frontier_and_dropped():
    s = _state(0.3, 0.1, best_sse=1.0)
    np.testing.assert_allclose(float(so3.certified_gap(s)), 0.9, rtol=1e-6)


def test_certified_gap_closed_leaf_holds_gap_open():
    """A terminal leaf closed at rotation_min_span keeps bounding the
    gap (SO3State.closed_lb): frontier exhaustion with a discarded
    claim leaf must NOT read as a certificate (the r5 bun090 regression
    class)."""
    s = _state(float(so3.INVALID), float(so3.INVALID), best_sse=1.0,
               closed_lb=0.05)
    np.testing.assert_allclose(float(so3.certified_gap(s)), 0.95,
                               rtol=1e-6)
    # ...but once the incumbent is within the slack of the closed leaf
    # the gap closes like any other floor.
    s2 = _state(float(so3.INVALID), float(so3.INVALID), best_sse=0.1,
                closed_lb=0.05)
    np.testing.assert_allclose(float(so3.certified_gap(s2)), 0.05,
                               rtol=1e-6)
