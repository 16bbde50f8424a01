"""Sharded (cubes x points) paths must match the single-device engine."""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fgoicp.models import icp as icp_model
from fgoicp.ops import bounds as bounds_ops
from fgoicp.ops import frontier as frontier_ops
from fgoicp.ops import geometry as geo
from fgoicp.parallel import bnb as pbnb
from fgoicp.parallel import sharding as psh


def _problem(seed=0, nt=131, ns=67, g=9):
    rng = np.random.default_rng(seed)
    pct = jnp.asarray(rng.uniform(-0.8, 0.8, size=(nt, 3)), jnp.float32)
    pcs = jnp.asarray(rng.uniform(-0.6, 0.6, size=(ns, 3)), jnp.float32)
    backend = bounds_ops.make_backend(pct, kind="exact")
    xyz = jnp.asarray(rng.uniform(-0.5, 0.5, size=(g, 3)), jnp.float32)
    R = geo.quat_cube_to_matrix(xyz)
    spans = jnp.full((g,), 0.25, jnp.float32)
    fix = jnp.asarray(rng.integers(0, 2, size=(g,)).astype(bool))
    return backend, pct, pcs, R, spans, fix


@pytest.mark.parametrize("mesh_shape", [(4, 2), (1, 8)])
def test_bnb_r3_sharded_matches_single_device(mesh_shape):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    backend, _, pcs, R, spans, fix = _problem()
    mesh = psh.make_mesh(*mesh_shape)
    kw = dict(batch=4, capacity=128, max_steps=50)
    ref = frontier_ops.bnb_r3_batched(
        backend, pcs, R, spans, fix, jnp.float32(1e9), jnp.float32(1e-4), **kw)
    st = pbnb.bnb_r3_sharded(
        backend, pcs, R, spans, fix, jnp.float32(1e9), jnp.float32(1e-4),
        mesh=mesh, **kw)
    np.testing.assert_allclose(np.asarray(st.best_ub), np.asarray(ref.best_ub),
                               rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(st.best_t), np.asarray(ref.best_t),
                               rtol=2e-4, atol=1e-6)
    # Same number of evaluated nodes per group (identical search shape).
    np.testing.assert_array_equal(np.asarray(st.evaluated),
                                  np.asarray(ref.evaluated))


@pytest.mark.parametrize("mesh_shape", [(4, 2), (2, 4)])
def test_pooled_sharded_clusters_share_match_single_device(mesh_shape):
    """Sharded pooled BnB with weighted source clusters + twin incumbent
    sharing must match the single-device pooled path (round-1 gap: these
    features silently degraded on multi-chip runs)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    from fgoicp.ops import coreset as coreset_ops
    from fgoicp.ops import pool_frontier
    backend, _, pcs, R, spans, fix = _problem(seed=7, g=4)
    g = R.shape[0]
    clusters = coreset_ops.build_weighted(pcs, size=24, seed=7)
    # ub-pass twins in lanes [0:g), lb-pass in [g:2g) like the engine.
    R2 = jnp.concatenate([R, R])
    spans2 = jnp.concatenate([spans, spans])
    fix2 = jnp.concatenate([jnp.ones((g,), bool), jnp.zeros((g,), bool)])
    share = jnp.concatenate([jnp.full((g,), -1, jnp.int32),
                             jnp.arange(g, dtype=jnp.int32)])
    # Capacity large enough that neither scheduler drops nodes — a shared
    # pool under overflow legitimately diverges from per-shard pools (the
    # dropped_lb clamp covers that case; see test_pool_frontier).
    kw = dict(lanes=32, capacity=32768, max_steps=4000,
              point_weights=clusters.weights, point_deltas=clusters.deltas,
              err_share_from=share)
    ref = pool_frontier.bnb_r3_pooled(
        backend, clusters.reps, R2, spans2, fix2,
        jnp.float32(1e9), jnp.float32(1e-4), **kw)
    mesh = psh.make_mesh(*mesh_shape)
    st = pbnb.bnb_r3_pooled_sharded(
        backend, clusters.reps, R2, spans2, fix2,
        jnp.float32(1e9), jnp.float32(1e-4), mesh=mesh, **kw)
    assert int(np.asarray(ref.dropped)) == 0
    assert int(np.asarray(st.dropped).sum()) == 0
    np.testing.assert_allclose(np.asarray(st.best_ub),
                               np.asarray(ref.best_ub), rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(st.best_err),
                               np.asarray(ref.best_err), rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4)])
def test_trimmed_bounds_sharded_match_single_device(mesh_shape):
    """Trimmed registration under point sharding: the global top-k merge
    must reproduce the single-device trimmed sums exactly."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    backend, _, pcs, R, spans, fix = _problem(seed=8, g=4)
    keep = int(pcs.shape[0] * 0.8)
    # Run to convergence: the sharded partial-sum order differs by f32
    # noise (~5e-7), which can flip near-tie prune decisions mid-search;
    # at gap termination both prove the same optima within the threshold.
    kw = dict(batch=4, capacity=1024, max_steps=500, trim_keep=keep)
    ref = frontier_ops.bnb_r3_batched(
        backend, pcs, R, spans, fix, jnp.float32(1e9), jnp.float32(1e-4),
        **kw)
    mesh = psh.make_mesh(*mesh_shape)
    st = pbnb.bnb_r3_sharded(
        backend, pcs, R, spans, fix, jnp.float32(1e9), jnp.float32(1e-4),
        mesh=mesh, **kw)
    np.testing.assert_allclose(np.asarray(st.best_ub),
                               np.asarray(ref.best_ub), rtol=1e-3, atol=2e-4)
    assert np.all(np.asarray(st.evaluated) > 0)


def test_icp_sharded_matches_single_device():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    rng = np.random.default_rng(3)
    pct = jnp.asarray(rng.uniform(-1, 1, size=(200, 3)), jnp.float32)
    # Source = rotated subset of the target: ICP should recover it.
    xyz = jnp.asarray([[0.05, -0.02, 0.04]], jnp.float32)
    R_true = geo.quat_cube_to_matrix(xyz)[0]
    pcs = (pct[:120] - jnp.asarray([0.02, 0.0, -0.01])) @ R_true
    g = 5
    R0 = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (g, 3, 3))
    t0 = jnp.zeros((g, 3), jnp.float32)
    mesh = psh.make_mesh(4, 2)
    sse_ref, R_ref, t_ref = icp_model.icp_batched(
        pct, pcs, R0, t0, max_iter=20, convergence_threshold=0.005)
    sse_sh, R_sh, t_sh = pbnb.icp_sharded(
        pct, pcs, R0, t0, mesh=mesh, max_iter=20,
        convergence_threshold=0.005)
    np.testing.assert_allclose(np.asarray(sse_sh), np.asarray(sse_ref),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(np.asarray(R_sh), np.asarray(R_ref),
                               rtol=1e-4, atol=1e-5)


def test_goicp_on_mesh_pooled():
    """Full GoICP with a (cubes, points) mesh: pooled-sharded inner BnB +
    target-sharded ICP end-to-end."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    import sys
    sys.path.insert(0, "/root/repo/tests")
    from util import std_engine
    from fgoicp.models.goicp import GoICP
    rng = np.random.default_rng(11)
    s = rng.uniform(0.0, 4.5, size=(150,))
    pct = np.stack([np.cos(s), 0.7 * np.sin(2 * s),
                    0.4 * np.sin(3 * s + 0.5)], axis=1)
    pct = (pct + rng.normal(scale=0.01, size=(150, 3))).astype(np.float32)
    ang = 2.0
    c, s0 = np.cos(ang), np.sin(ang)
    R_true = np.array([[c, -s0, 0], [s0, c, 0], [0, 0, 1]], np.float32)
    t_true = np.array([0.2, -0.1, 0.15], np.float32)
    pcs = (pct[:100] - t_true) @ R_true
    mesh = psh.make_mesh(4, 2)
    m = GoICP(pct, pcs, mse_threshold=5e-4, engine=std_engine(),
              bound_backend="exact", mesh=mesh)
    R, t = m.run()
    np.testing.assert_allclose(R, R_true, atol=2e-3)
    np.testing.assert_allclose(t, t_true, atol=2e-3)
    assert m.stats.translation_nodes > 0


def test_device_outer_points_sharded():
    """outer_mode='device' with the points axis sharded: the replicated
    SO(3) frontier + psum'd bounds + pmin-vote ICP must reach the same
    optimum as the unsharded device run."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    sys.path.insert(0, "/root/repo/tests")
    from util import std_engine
    from fgoicp.models.goicp import GoICP
    rng = np.random.default_rng(21)
    s = rng.uniform(0.0, 4.5, size=(150,))
    pct = np.stack([np.cos(s), 0.7 * np.sin(2 * s),
                    0.4 * np.sin(3 * s + 0.5)], axis=1)
    pct = (pct + rng.normal(scale=0.01, size=(150, 3))).astype(np.float32)
    ang = 2.0
    c, s0 = np.cos(ang), np.sin(ang)
    R_true = np.array([[c, -s0, 0], [s0, c, 0], [0, 0, 1]], np.float32)
    t_true = np.array([0.2, -0.1, 0.15], np.float32)
    pcs = (pct[:100] - t_true) @ R_true

    single = GoICP(pct, pcs, mse_threshold=5e-4,
                   engine=std_engine(outer_mode="device", so3_capacity=2048),
                   bound_backend="exact")
    single.run()
    mesh = psh.make_mesh(1, 8)
    m = GoICP(pct, pcs, mse_threshold=5e-4,
              engine=std_engine(outer_mode="device", so3_capacity=2048),
              bound_backend="exact", mesh=mesh)
    R, t = m.run()
    assert m.mse < 5e-4
    np.testing.assert_allclose(R, R_true, atol=2e-3)
    np.testing.assert_allclose(t, t_true, atol=2e-3)
    assert abs(m.best_sse - single.best_sse) <= \
        1e-3 * max(single.best_sse, 1e-9) + 1e-9


def test_device_outer_cubes_sharded():
    """outer_mode='device' on a (cubes x points) mesh: the replicated
    SO(3) frontier with sliced child evaluation must explore the same
    outer octree as a single-device run with the scaled rotation batch
    and reach the same certified optimum."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    sys.path.insert(0, "/root/repo/tests")
    from util import std_engine
    from fgoicp.models.goicp import GoICP
    rng = np.random.default_rng(23)
    s = rng.uniform(0.0, 4.5, size=(150,))
    pct = np.stack([np.cos(s), 0.7 * np.sin(2 * s),
                    0.4 * np.sin(3 * s + 0.5)], axis=1)
    pct = (pct + rng.normal(scale=0.01, size=(150, 3))).astype(np.float32)
    ang = 2.0
    c, s0 = np.cos(ang), np.sin(ang)
    R_true = np.array([[c, -s0, 0], [s0, c, 0], [0, 0, 1]], np.float32)
    t_true = np.array([0.2, -0.1, 0.15], np.float32)
    pcs = (pct[:100] - t_true) @ R_true

    # Single-device with rotation_batch = n_cubes * rb for the same
    # outer octree shape (rb=2 from std_engine, 4 cube shards).
    single = GoICP(pct, pcs, mse_threshold=5e-4,
                   engine=std_engine(outer_mode="device",
                                     so3_capacity=2048, rotation_batch=8),
                   bound_backend="exact")
    single.run()

    mesh42 = psh.make_mesh(4, 2)
    m = GoICP(pct, pcs, mse_threshold=5e-4,
              engine=std_engine(outer_mode="device", so3_capacity=2048),
              bound_backend="exact", mesh=mesh42)
    R, t = m.run()
    assert m.mse < 5e-4
    np.testing.assert_allclose(R, R_true, atol=2e-3)
    np.testing.assert_allclose(t, t_true, atol=2e-3)
    assert abs(m.best_sse - single.best_sse) <= \
        1e-3 * max(single.best_sse, 1e-9) + 1e-9
    # Same outer octree scale (inner scheduling may differ within the
    # termination gap, so node counts need not match exactly).
    assert m.stats.outer_steps == single.stats.outer_steps


def test_graft_entry_and_dryrun():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    sys.path.insert(0, "/root/repo")
    try:
        import __graft_entry__ as ge
    finally:
        sys.path.pop(0)
    fn, args = ge.entry()
    lb, ub = jax.jit(fn)(*args)
    assert lb.shape == ub.shape == (8, 16)
    assert bool(jnp.all(lb <= ub + 1e-5))
    ge.dryrun_multichip(8)
    ge.dryrun_multichip(3)  # odd count: points axis collapses to 1
