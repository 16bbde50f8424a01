"""Golden end-to-end tests on the real reference datasets (bunny, skull,
dragon, scan pairs).  Skipped when /root/reference/data is absent.

The reference has no automated tests; its implicit check is ground-truth
recovery of a known transform (scripts/transform_point_cloud.py, SURVEY
§4) — here seeded and asserted, on heavily subsampled clouds so the CPU
suite stays tractable."""
import os

import numpy as np
import pytest

from util import std_engine
from fgoicp.io import load_cloud
from fgoicp.models.goicp import GoICP
from fgoicp.models.icp import icp_register
from fgoicp.ops import geometry as geo

DATA = "/root/reference/data"
BUNNY = f"{DATA}/bunny/model_bunny.txt"
SKULL = f"{DATA}/artec3d/data_skull.ply"
DRAGON_A = f"{DATA}/dragon/dragonClearSpace2_0.ply"
DRAGON_B = f"{DATA}/dragon/dragonToes3_0.ply"

needs_data = pytest.mark.skipif(not os.path.isdir(DATA),
                                reason="reference data not mounted")


def _known_pair(pct, n_src, angle_xyz, t, seed=0):
    """Source = R @ subsample(target) + t; registration should return
    (R^T, -R^T t)."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(pct), size=n_src, replace=False)
    xyz = np.asarray(angle_xyz, np.float32)
    R = np.asarray(geo.quat_cube_to_matrix(xyz))
    pcs = pct[idx] @ R.T + np.asarray(t, np.float32)
    return pcs, R, np.asarray(t, np.float32)


def _assert_recovered(R, t, R_true, t_true, tol=5e-3):
    err_R = np.abs(np.asarray(R) @ R_true - np.eye(3)).max()
    err_t = np.abs(np.asarray(R) @ t_true + np.asarray(t)).max()
    assert err_R < tol, f"rotation error {err_R}"
    assert err_t < tol, f"translation error {err_t}"


@needs_data
def test_bunny_icp_slice():
    """Config 1: plain ICP on a small known-transform bunny pair."""
    pct = load_cloud(BUNNY, 0.05, seed=1)
    pcs, R_true, t_true = _known_pair(
        pct, 400, [0.02, -0.03, 0.025], [0.01, -0.02, 0.005])
    sse, R, t = icp_register(pct, pcs, max_iter=60,
                             convergence_threshold=0.0005)
    _assert_recovered(R, t, R_true, t_true)


@needs_data
def test_bunny_goicp_large_rotation():
    """Config 2: full BnB recovers a rotation plain ICP cannot."""
    pct = load_cloud(BUNNY, 0.015, seed=1)
    pcs, R_true, t_true = _known_pair(
        pct, 200, [0.05, 0.62, -0.1], [0.02, -0.01, 0.03])
    m = GoICP(pct, pcs, mse_threshold=5e-4, engine=std_engine())
    R, t = m.run()
    _assert_recovered(R, t, R_true, t_true, tol=2e-2)
    assert m.stats.rotation_children > 0  # BnB actually searched


@needs_data
def test_skull_binary_ply_goicp():
    """Config 3: artec3d skull (binary_le PLY, 98,359 pts header)."""
    full = load_cloud(SKULL, 0.008, seed=2)
    assert len(full) > 500
    pcs, R_true, t_true = _known_pair(
        full, 200, [-0.3, 0.2, 0.4], [5.0, -3.0, 2.0], seed=3)
    m = GoICP(full, pcs, mse_threshold=5e-4, engine=std_engine())
    R, t = m.run()
    _assert_recovered(R, t, R_true, t_true, tol=2e-2)


@needs_data
def test_dragon_trimmed_partial_overlap():
    """Config 4: dragon scan with outlier contamination + trimming."""
    pct = load_cloud(DRAGON_A, 0.006, seed=4)
    pcs, R_true, t_true = _known_pair(
        pct, 250, [0.1, -0.45, 0.2], [0.05, 0.02, -0.04], seed=5)
    rng = np.random.default_rng(6)
    lo, hi = pcs.min(axis=0), pcs.max(axis=0)
    outliers = rng.uniform(lo - 0.1, hi + 0.1, size=(50, 3)).astype(np.float32)
    pcs_noisy = np.concatenate([pcs, outliers])
    m = GoICP(pct, pcs_noisy, mse_threshold=5e-4, engine=std_engine(),
              trim_fraction=0.25)
    R, t = m.run()
    _assert_recovered(R, t, R_true, t_true, tol=5e-2)
