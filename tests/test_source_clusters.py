"""Weighted source-cluster bounds: validity against the true SSE."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from util import std_engine
from fgoicp.models.goicp import GoICP
from fgoicp.ops import bounds as bounds_ops
from fgoicp.ops import coreset as coreset_ops
from fgoicp.ops import geometry as geo
from fgoicp.ops import nn as nn_ops


def _cloud(rng, n):
    s = rng.uniform(0.0, 4.5, size=(n,))
    pts = np.stack([np.cos(s), 0.7 * np.sin(2 * s),
                    0.4 * np.sin(3 * s + 0.5)], axis=1)
    return (pts + rng.normal(scale=0.01, size=(n, 3))).astype(np.float32)


def test_build_weighted_partitions():
    rng = np.random.default_rng(0)
    pts = _cloud(rng, 500)
    cl = coreset_ops.build_weighted(pts, size=64, seed=1)
    assert cl.reps.shape == (64, 3)
    np.testing.assert_allclose(float(jnp.sum(cl.weights)), 500.0)
    # Every point is within its cluster radius of some representative.
    d2, idx = nn_ops.nearest_neighbor(pts, cl.reps)
    d = np.sqrt(np.asarray(d2))
    assert np.all(d <= np.asarray(cl.deltas)[np.asarray(idx)] + 1e-6)


def test_cluster_bounds_bracket_true_sse():
    """Cluster lb <= min SSE over the node region; cluster ub >= SSE at
    the node center — checked against dense random samples in-region."""
    rng = np.random.default_rng(1)
    pct = _cloud(rng, 300)
    pcs = _cloud(rng, 220)
    backend = bounds_ops.make_backend(pct, kind="exact")
    cl = coreset_ops.build_weighted(pcs, size=48, seed=2)

    g = 4
    xyz = rng.uniform(-0.4, 0.4, size=(g, 3)).astype(np.float32)
    spans = np.full((g,), 0.15, np.float32)
    tc = rng.uniform(-0.3, 0.3, size=(g, 1, 3)).astype(np.float32)
    ts = np.full((g, 1), 0.1, np.float32)
    R = geo.quat_cube_to_matrix(jnp.asarray(xyz))
    # Half the groups fixed-rotation (the reference's ub pass), half
    # gamma-relaxed (the lb pass).
    fix = jnp.asarray([True, True, False, False])

    lb, ub = bounds_ops.evaluate_bounds(
        backend, cl.reps, R, jnp.asarray(spans), fix, jnp.asarray(tc),
        jnp.asarray(ts), point_weights=cl.weights, point_deltas=cl.deltas)
    lb = np.asarray(lb)[:, 0]
    ub = np.asarray(ub)[:, 0]

    def per_point_d(xyz_r, t_vec):
        Rm = geo.quat_cube_to_matrix(jnp.asarray(xyz_r, jnp.float32))
        q = jnp.asarray(pcs) @ Rm.T + jnp.asarray(t_vec, jnp.float32)
        return np.sqrt(np.maximum(
            np.asarray(nn_ops.nearest_sqdist(q, pct)), 0.0))

    norms = np.linalg.norm(pcs, axis=1)
    for k in range(g):
        d_center = per_point_d(xyz[k], tc[k, 0])
        if bool(fix[k]):
            # Fixed rotation: ub >= exact SSE at the center transform.
            center_sse = float(np.sum(d_center ** 2))
            assert ub[k] >= center_sse * (1 - 1e-4) - 1e-3, \
                f"group {k}: ub {ub[k]} < center SSE {center_sse}"
        else:
            # Relaxed: ub >= the per-point gamma-relaxed objective.
            gam = np.asarray(geo.rotation_uncertainty_radius(
                jnp.asarray(norms), jnp.float32(spans[k])))
            relaxed = float(np.sum(np.maximum(d_center - gam, 0.0) ** 2))
            assert ub[k] >= relaxed * (1 - 1e-4) - 1e-3, \
                f"group {k}: ub {ub[k]} < relaxed objective {relaxed}"
        # lb <= SSE everywhere in the region (sampled).  Fixed-rotation
        # groups only cover the translation region (gamma_r = 0).
        for _ in range(6):
            dt = rng.uniform(-ts[k, 0], ts[k, 0], size=3)
            if bool(fix[k]):
                v = xyz[k]
            else:
                dx = rng.uniform(-spans[k], spans[k], size=3)
                v = np.clip(xyz[k] + dx, -0.999, 0.999)
                if np.sum(v * v) > 1.0:
                    v = v / np.linalg.norm(v) * 0.999
            s = float(np.sum(per_point_d(v, tc[k, 0] + dt) ** 2))
            assert lb[k] <= s + 1e-3 + 1e-4 * s, \
                f"group {k}: lb {lb[k]} > sampled SSE {s}"


def test_trimmed_cluster_bounds_bracket_trimmed_sse():
    """Weighted member-level trim over clusters (round-3 feature — the
    round-2 engine disabled clusters when trimming): trimmed cluster lb
    <= trimmed true SSE over the node region; fixed-rotation ub >= the
    trimmed SSE at the node center."""
    rng = np.random.default_rng(5)
    pct = _cloud(rng, 300)
    pcs = _cloud(rng, 220)
    ns = len(pcs)
    keep = int(ns * 0.7)
    backend = bounds_ops.make_backend(pct, kind="exact")
    cl = coreset_ops.build_weighted(pcs, size=48, seed=4)

    g = 4
    xyz = rng.uniform(-0.4, 0.4, size=(g, 3)).astype(np.float32)
    spans = np.full((g,), 0.15, np.float32)
    tc = rng.uniform(-0.3, 0.3, size=(g, 1, 3)).astype(np.float32)
    ts = np.full((g, 1), 0.1, np.float32)
    R = geo.quat_cube_to_matrix(jnp.asarray(xyz))
    fix = jnp.asarray([True, True, False, False])

    lb, ub = bounds_ops.evaluate_bounds(
        backend, cl.reps, R, jnp.asarray(spans), fix, jnp.asarray(tc),
        jnp.asarray(ts), point_weights=cl.weights, point_deltas=cl.deltas,
        trim_keep=keep, trim_ns=ns)
    lb = np.asarray(lb)[:, 0]
    ub = np.asarray(ub)[:, 0]

    def trimmed_sse(xyz_r, t_vec):
        Rm = geo.quat_cube_to_matrix(jnp.asarray(xyz_r, jnp.float32))
        q = jnp.asarray(pcs) @ Rm.T + jnp.asarray(t_vec, jnp.float32)
        d2 = np.sort(np.maximum(
            np.asarray(nn_ops.nearest_sqdist(q, pct)), 0.0))
        return float(np.sum(d2[:keep]))

    for k in range(g):
        if bool(fix[k]):
            center = trimmed_sse(xyz[k], tc[k, 0])
            assert ub[k] >= center * (1 - 1e-4) - 1e-3, \
                f"group {k}: trimmed ub {ub[k]} < center trimmed SSE {center}"
        for _ in range(6):
            dt = rng.uniform(-ts[k, 0], ts[k, 0], size=3)
            if bool(fix[k]):
                v = xyz[k]
            else:
                dx = rng.uniform(-spans[k], spans[k], size=3)
                v = np.clip(xyz[k] + dx, -0.999, 0.999)
                if np.sum(v * v) > 1.0:
                    v = v / np.linalg.norm(v) * 0.999
            s = trimmed_sse(v, tc[k, 0] + dt)
            assert lb[k] <= s + 1e-3 + 1e-4 * s, \
                f"group {k}: trimmed lb {lb[k]} > sampled trimmed SSE {s}"


def test_weighted_drop_sum_greedy_exact():
    """_weighted_drop_sum must equal the brute-force member-level top-k."""
    rng = np.random.default_rng(6)
    for _ in range(5):
        k = 7
        v = rng.uniform(0, 3, size=(k,)).astype(np.float32)
        w = rng.integers(1, 5, size=(k,)).astype(np.float32)
        n_drop = int(rng.integers(1, int(w.sum())))
        members = np.repeat(v, w.astype(int))
        want = float(np.sort(members)[::-1][:n_drop].sum())
        got = float(bounds_ops._weighted_drop_sum(
            jnp.asarray(v)[None, :], jnp.asarray(w), n_drop)[0])
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_goicp_trimmed_with_clusters_recovers():
    """End-to-end trimmed registration WITH source clusters enabled: the
    engine must keep clusters (round 2 silently dropped them) and still
    recover the transform with 20% outlier source points."""
    rng = np.random.default_rng(7)
    pct = _cloud(rng, 400)
    ang = 2.0
    c, s = np.cos(ang), np.sin(ang)
    R_true = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    t_true = np.array([0.2, -0.1, 0.15], np.float32)
    inliers = (pct[:240] - t_true) @ R_true
    outliers = rng.uniform(-1.2, 1.2, size=(60, 3)).astype(np.float32)
    pcs = np.concatenate([inliers, outliers])
    m = GoICP(pct, pcs, mse_threshold=2e-3,
              engine=std_engine(source_coreset=96),
              trim_fraction=0.25)
    assert m.src_clusters is not None, \
        "clusters must stay enabled under trimming"
    assert m.trim_keep is not None
    R, t = m.run()
    np.testing.assert_allclose(R, R_true, atol=5e-3)
    np.testing.assert_allclose(t, t_true, atol=5e-3)


def test_goicp_with_source_coreset_recovers():
    rng = np.random.default_rng(3)
    pct = _cloud(rng, 400)
    ang = 2.0
    c, s = np.cos(ang), np.sin(ang)
    R_true = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    t_true = np.array([0.2, -0.1, 0.15], np.float32)
    pcs = (pct[:300] - t_true) @ R_true
    m = GoICP(pct, pcs, mse_threshold=5e-4,
              engine=std_engine(source_coreset=96))
    assert m.src_clusters is not None
    R, t = m.run()
    np.testing.assert_allclose(R, R_true, atol=2e-3)
    np.testing.assert_allclose(t, t_true, atol=2e-3)
