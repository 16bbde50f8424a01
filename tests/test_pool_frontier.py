"""Pooled frontier must reach the same per-group results as the
per-group lockstep frontier (same bounds math, different pop order)."""
import jax.numpy as jnp
import numpy as np
import pytest

from fgoicp.ops import bounds as bounds_ops
from fgoicp.ops import frontier as frontier_ops
from fgoicp.ops import geometry as geo
from fgoicp.ops import pool_frontier


def _problem(seed=0, nt=131, ns=67, g=6):
    rng = np.random.default_rng(seed)
    pct = jnp.asarray(rng.uniform(-0.8, 0.8, size=(nt, 3)), jnp.float32)
    pcs = jnp.asarray(rng.uniform(-0.6, 0.6, size=(ns, 3)), jnp.float32)
    backend = bounds_ops.make_backend(pct, kind="exact")
    xyz = jnp.asarray(rng.uniform(-0.5, 0.5, size=(g, 3)), jnp.float32)
    R = geo.quat_cube_to_matrix(xyz)
    spans = jnp.full((g,), 0.25, jnp.float32)
    fix = jnp.asarray([True, False] * (g // 2))
    return backend, pcs, R, spans, fix


@pytest.mark.parametrize("lanes", [32])
def test_pooled_matches_grouped(lanes):
    backend, pcs, R, spans, fix = _problem()
    args = (backend, pcs, R, spans, fix,
            jnp.float32(1e9), jnp.float32(1e-4))
    ref = frontier_ops.bnb_r3_batched(*args, batch=8, capacity=1024,
                                      max_steps=300)
    st = pool_frontier.bnb_r3_pooled(*args, lanes=lanes, capacity=4096,
                                     max_steps=2000)
    # The pop ORDER differs, so node counts may differ, but both searches
    # prove the same per-group optima.
    np.testing.assert_allclose(np.asarray(st.best_ub),
                               np.asarray(ref.best_ub), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(st.best_err),
                               np.asarray(ref.best_err), rtol=1e-4, atol=1e-6)
    # Translations achieving the min-ub may be any member of the argmin
    # set; verify by re-evaluating the bounds at the returned t.
    g = R.shape[0]
    lbr, ubr = bounds_ops.evaluate_bounds(
        backend, pcs, R, spans, fix, st.best_t[:, None, :],
        jnp.zeros((g, 1), jnp.float32))
    np.testing.assert_allclose(np.asarray(ubr[:, 0]),
                               np.asarray(st.best_ub), rtol=1e-4, atol=1e-6)
    assert int(st.steps) < 2000
    assert np.all(np.asarray(st.evaluated) > 0)


def test_pooled_respects_inactive_groups():
    backend, pcs, R, spans, fix = _problem(seed=1)
    act = jnp.asarray([True, False, True, False, True, False])
    st = pool_frontier.bnb_r3_pooled(
        backend, pcs, R, spans, fix, jnp.float32(1e9), jnp.float32(1e-4),
        group_active=act, lanes=32, capacity=2048, max_steps=2000)
    ev = np.asarray(st.evaluated)
    assert np.all(ev[~np.asarray(act)] == 0)
    assert np.all(ev[np.asarray(act)] > 0)


def test_pooled_deterministic():
    """Same inputs -> bitwise-identical search results (determinism is a
    feature; the reference's runs aren't even repeatable, SURVEY §2 row 3)."""
    backend, pcs, R, spans, fix = _problem(seed=3)
    args = (backend, pcs, R, spans, fix, jnp.float32(1e9), jnp.float32(1e-4))
    a = pool_frontier.bnb_r3_pooled(*args, lanes=32, capacity=2048)
    b = pool_frontier.bnb_r3_pooled(*args, lanes=32, capacity=2048)
    np.testing.assert_array_equal(np.asarray(a.best_ub), np.asarray(b.best_ub))
    np.testing.assert_array_equal(np.asarray(a.best_t), np.asarray(b.best_t))
    np.testing.assert_array_equal(np.asarray(a.evaluated),
                                  np.asarray(b.evaluated))
    assert int(a.steps) == int(b.steps)


def test_pool_overflow_keeps_lb_sound():
    """Tiny capacity forces node drops; the dropped_lb-clamped result must
    remain a valid lower bound on the group objective (an unclamped result
    can exceed it and silently void the optimality certificate)."""
    backend, pcs, R, spans, fix = _problem(seed=4)
    g = R.shape[0]
    args = (backend, pcs, R, spans, fix, jnp.float32(1e9), jnp.float32(1e-4))
    big = pool_frontier.bnb_r3_pooled(*args, lanes=32, capacity=8192,
                                      max_steps=3000)
    small = pool_frontier.bnb_r3_pooled(*args, lanes=8, capacity=g + 4,
                                        max_steps=3000)
    assert int(small.dropped) > 0, "capacity g+4 must overflow"
    lb_sound = np.minimum(
        np.minimum(np.asarray(small.best_ub), np.asarray(small.best_err)),
        np.asarray(small.dropped_lb))
    # big.best_ub is an ACHIEVED objective value, so true_min <= big.best_ub;
    # a sound lower bound can therefore never exceed it.
    assert np.all(lb_sound <= np.asarray(big.best_ub) + 1e-5)


def test_grouped_overflow_keeps_lb_sound():
    backend, pcs, R, spans, fix = _problem(seed=5)
    args = (backend, pcs, R, spans, fix, jnp.float32(1e9), jnp.float32(1e-4))
    big = frontier_ops.bnb_r3_batched(*args, batch=8, capacity=1024,
                                      max_steps=500)
    small = frontier_ops.bnb_r3_batched(*args, batch=4, capacity=8,
                                        max_steps=500)
    assert int(np.asarray(small.dropped).sum()) > 0
    lb_sound = np.minimum(
        np.minimum(np.asarray(small.best_ub), np.asarray(small.best_err)),
        np.asarray(small.dropped_lb))
    assert np.all(lb_sound <= np.asarray(big.best_ub) + 1e-5)


def test_pool_max_steps_exit_keeps_lb_sound():
    """A max_steps-truncated search leaves unexplored frontier nodes whose
    lb can undercut the returned result; the exit clamp must fold the
    surviving frontier minimum into dropped_lb so min(result, dropped_lb)
    stays a valid lower bound (ADVICE r2: the certificate docs claim every
    lossy exit is clamped — this exit path included)."""
    backend, pcs, R, spans, fix = _problem(seed=6)
    args = (backend, pcs, R, spans, fix, jnp.float32(1e9), jnp.float32(1e-4))
    full = pool_frontier.bnb_r3_pooled(*args, lanes=32, capacity=8192,
                                       max_steps=3000)
    cut = pool_frontier.bnb_r3_pooled(*args, lanes=8, capacity=4096,
                                      max_steps=2)
    assert int(cut.steps) == 2
    lb_sound = np.minimum(
        np.minimum(np.asarray(cut.best_ub), np.asarray(cut.best_err)),
        np.asarray(cut.dropped_lb))
    assert np.all(lb_sound <= np.asarray(full.best_ub) + 1e-5)
    # The clamp must actually have fired for every group the truncation
    # left unconverged (converged groups keep the gap-termination
    # guarantee and stay unclamped).
    act = np.asarray(cut.active)
    assert act.any(), "2-step cutoff should leave unconverged groups"
    assert np.all(np.asarray(cut.dropped_lb)[act] < 1e29)


def test_grouped_max_steps_exit_keeps_lb_sound():
    backend, pcs, R, spans, fix = _problem(seed=7)
    args = (backend, pcs, R, spans, fix, jnp.float32(1e9), jnp.float32(1e-4))
    full = frontier_ops.bnb_r3_batched(*args, batch=8, capacity=1024,
                                       max_steps=500)
    cut = frontier_ops.bnb_r3_batched(*args, batch=4, capacity=1024,
                                      max_steps=2)
    assert int(cut.steps) == 2
    lb_sound = np.minimum(
        np.minimum(np.asarray(cut.best_ub), np.asarray(cut.best_err)),
        np.asarray(cut.dropped_lb))
    assert np.all(lb_sound <= np.asarray(full.best_ub) + 1e-5)


def test_pooled_trimmed_bounds():
    backend, pcs, R, spans, fix = _problem(seed=2)
    ns = pcs.shape[0]
    keep = int(ns * 0.8)
    ref = frontier_ops.bnb_r3_batched(
        backend, pcs, R, spans, fix, jnp.float32(1e9), jnp.float32(1e-4),
        batch=8, capacity=1024, max_steps=300, trim_keep=keep)
    st = pool_frontier.bnb_r3_pooled(
        backend, pcs, R, spans, fix, jnp.float32(1e9), jnp.float32(1e-4),
        lanes=32, capacity=2048, max_steps=2000, trim_keep=keep)
    np.testing.assert_allclose(np.asarray(st.best_ub),
                               np.asarray(ref.best_ub), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 3, 9])
def test_merge_update_matches_sort(seed):
    """pool_update='merge' (sorted-invariant pool + binary-search merge,
    dominance deferred to pop time) proves the same per-group optima.
    Parity is NEAR-exact: dominance is a per-group threshold, so a
    dominated entry of a small-incumbent group can sort ahead of a valid
    entry of another group and waste its pop lane — a few extra masked
    steps, never a different optimum (pool_frontier body comment)."""
    backend, pcs, R, spans, fix = _problem(seed=seed)
    args = (backend, pcs, R, spans, fix,
            jnp.float32(1e9), jnp.float32(1e-4))
    a = pool_frontier.bnb_r3_pooled(*args, lanes=32, capacity=4096,
                                    max_steps=2000, pool_update="sort")
    b = pool_frontier.bnb_r3_pooled(*args, lanes=32, capacity=4096,
                                    max_steps=2000, pool_update="merge")
    assert abs(int(a.steps) - int(b.steps)) <= max(3, int(a.steps) // 10)
    np.testing.assert_allclose(np.asarray(a.best_ub),
                               np.asarray(b.best_ub), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(a.best_err),
                               np.asarray(b.best_err), rtol=1e-5, atol=1e-7)
    assert int(a.dropped) == int(b.dropped) == 0


def test_merge_update_inactive_groups():
    """Init-sort handles INVALID holes among the root slots."""
    backend, pcs, R, spans, fix = _problem(seed=2)
    g = R.shape[0]
    act = jnp.asarray([True, False, True, True, False, True])
    args = (backend, pcs, R, spans, fix,
            jnp.float32(1e9), jnp.float32(1e-4))
    a = pool_frontier.bnb_r3_pooled(*args, group_active=act, lanes=32,
                                    capacity=4096, pool_update="sort")
    b = pool_frontier.bnb_r3_pooled(*args, group_active=act, lanes=32,
                                    capacity=4096, pool_update="merge")
    np.testing.assert_array_equal(np.asarray(a.best_ub),
                                  np.asarray(b.best_ub))
    np.testing.assert_array_equal(np.asarray(a.evaluated),
                                  np.asarray(b.evaluated))
    assert not np.any(np.asarray(b.evaluated)[~np.asarray(act)])


def test_merge_update_overflow_keeps_lb_sound():
    """Under capacity overflow the merge scheduler may retain dominated
    entries where sort frees them (different drop sets), but the
    dropped_lb-clamped certificate must stay sound."""
    backend, pcs, R, spans, fix = _problem(seed=4)
    g = R.shape[0]
    args = (backend, pcs, R, spans, fix, jnp.float32(1e9), jnp.float32(1e-4))
    big = pool_frontier.bnb_r3_pooled(*args, lanes=32, capacity=8192,
                                      max_steps=3000)
    small = pool_frontier.bnb_r3_pooled(*args, lanes=8, capacity=g + 4,
                                        max_steps=3000, pool_update="merge")
    assert int(small.dropped) > 0, "capacity g+4 must overflow"
    lb_sound = np.minimum(
        np.minimum(np.asarray(small.best_ub), np.asarray(small.best_err)),
        np.asarray(small.dropped_lb))
    assert np.all(lb_sound <= np.asarray(big.best_ub) + 1e-5)
