"""Edge cases and input validation (the reference exits/crashes on most
of these; SURVEY §5 'failure detection: none')."""
import numpy as np
import pytest

from util import std_engine
from fgoicp.models.goicp import GoICP
from fgoicp.models.icp import icp_register
from fgoicp.ops import procrustes as proc
from fgoicp.io import loader


def test_rejects_bad_shapes():
    good = np.zeros((10, 3), np.float32)
    with pytest.raises(ValueError, match=r"\[N, 3\]"):
        GoICP(np.zeros((10, 2), np.float32), good)
    with pytest.raises(ValueError, match="at least 3"):
        GoICP(good, np.zeros((2, 3), np.float32))


def test_rejects_nonfinite():
    good = np.random.default_rng(0).normal(size=(20, 3)).astype(np.float32)
    bad = good.copy()
    bad[3, 1] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        GoICP(bad, good)
    bad[3, 1] = np.inf
    with pytest.raises(ValueError, match="NaN"):
        GoICP(good, bad)


def test_icp_degenerate_collinear_source():
    """Collinear points make the cross-covariance singular; the polar
    solve must stay finite (ridge guard in ops/procrustes.py)."""
    t = np.linspace(0, 1, 40, dtype=np.float32)
    line = np.stack([t, 2 * t, -t], axis=1)
    target = np.random.default_rng(1).normal(size=(60, 3)).astype(np.float32)
    sse, R, tr = icp_register(target, line, max_iter=5)
    assert np.all(np.isfinite(np.asarray(R)))
    assert np.all(np.isfinite(np.asarray(tr)))
    # Still a proper rotation.
    np.testing.assert_allclose(np.asarray(R) @ np.asarray(R).T, np.eye(3),
                               atol=1e-4)


def test_procrustes_identical_points():
    """All-identical correspondences: zero covariance, must not NaN."""
    src = np.zeros((2, 10, 3), np.float32)
    corr = np.ones((2, 10, 3), np.float32)
    R, t = proc.procrustes(src, corr)
    assert np.all(np.isfinite(np.asarray(R)))
    np.testing.assert_allclose(np.asarray(t), 1.0, atol=1e-5)


def test_identical_clouds_register_to_identity():
    rng = np.random.default_rng(2)
    pc = rng.normal(size=(80, 3)).astype(np.float32)
    m = GoICP(pc, pc, mse_threshold=1e-4, engine=std_engine())
    R, t = m.run()
    np.testing.assert_allclose(R, np.eye(3), atol=1e-3)
    np.testing.assert_allclose(t, 0.0, atol=1e-3)


def test_subsample_extremes():
    pts = np.arange(30, dtype=np.float32).reshape(10, 3)
    assert len(loader.subsample_cloud(pts, 1.0)) == 10
    tiny = loader.subsample_cloud(pts, 1e-5, seed=0)
    assert len(tiny) <= 1  # cap = floor(10 * 1e-5) = 0
