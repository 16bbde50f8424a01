"""Batched multi-pair serving mode (models/serving.py): seeding
certificates, GoICP parity, BnB fallback, and mesh sharding."""
import numpy as np
import pytest

from fgoicp.models import serving
from fgoicp.models.goicp import GoICP

from util import std_engine


def _surface(n, seed=0):
    """Anisotropic bumpy blob: near-symmetric shapes (spheres) leave ICP
    basins tiny and every pair would exercise only the fallback path."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    r = 1.0 + 0.3 * np.sin(3 * v[:, :1]) + 0.2 * np.cos(2 * v[:, 1:2])
    return (v * r * np.array([1.0, 0.7, 0.5])).astype(np.float32)


def _rot(axis, ang):
    axis = np.asarray(axis, np.float64)
    axis /= np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return (np.eye(3) + np.sin(ang) * K +
            (1 - np.cos(ang)) * (K @ K)).astype(np.float32)


def _make_pairs(pct, b, ns, seed=1, max_angle=0.5):
    """Known-transform source batch: sources[i] = (sub_i - t_i) @ R_i
    so that R_i @ sources[i] + t_i reproduces target points."""
    rng = np.random.default_rng(seed)
    sources, Rs, ts = [], [], []
    for i in range(b):
        idx = rng.choice(len(pct), size=ns, replace=False)
        ax = rng.normal(size=3)
        R = _rot(ax, rng.uniform(0.1, max_angle))
        t = rng.uniform(-0.2, 0.2, size=3).astype(np.float32)
        sources.append((pct[idx] - t) @ R)
        Rs.append(R)
        ts.append(t)
    return np.stack(sources), Rs, ts


@pytest.fixture(scope="module")
def problem():
    pct = _surface(400)
    sources, Rs, ts = _make_pairs(pct, 4, 80)
    return pct, sources, Rs, ts


def test_batch_seeding_recovers(problem):
    pct, sources, Rs, ts = problem
    srv = serving.RegistrationService(pct, mse_threshold=1e-3,
                                      engine=std_engine(icp_multi_start=True))
    results = srv.register(sources)
    assert len(results) == len(sources)
    for r, R_true, t_true in zip(results, Rs, ts):
        assert r.certified
        assert not r.fallback_used
        assert r.mse <= 1e-3
        assert np.abs(r.R - R_true).max() < 5e-2
        assert np.abs(r.t - t_true).max() < 5e-2
    assert srv.stats.pairs == len(sources)
    assert srv.stats.certified_by_seeding == len(sources)
    assert srv.stats.fallbacks == 0


def test_parity_with_goicp(problem):
    """A pair certified by serving-seeding lands the same pose (and an
    equally certified error) as the full single-pair engine."""
    pct, sources, Rs, ts = problem
    eng = std_engine(icp_multi_start=True)
    srv = serving.RegistrationService(pct, mse_threshold=1e-3, engine=eng)
    r = srv.register(sources[:1])[0]
    model = GoICP(pct, sources[0], mse_threshold=1e-3, engine=eng)
    Rg, tg = model.run()
    assert np.abs(r.R - np.asarray(Rg)).max() < 5e-2
    assert np.abs(r.t - np.asarray(tg)).max() < 5e-2
    assert r.mse <= 1e-3 and model.mse <= 1e-3


def test_fallback_runs_bnb(problem):
    """With multi-start off and a ~180° pose offset, identity seeding
    stays in a wrong basin and the pair must fall back to the BnB."""
    pct, *_ = problem
    rng = np.random.default_rng(7)
    idx = rng.choice(len(pct), size=80, replace=False)
    R = _rot([0, 0, 1], np.pi * 0.95)
    t = np.asarray([0.1, -0.05, 0.04], np.float32)
    source = (pct[idx] - t) @ R
    srv = serving.RegistrationService(pct, mse_threshold=1e-3,
                                      engine=std_engine())
    res = srv.register(source[None])[0]
    assert res.fallback_used
    assert res.certified
    assert res.mse <= 1e-3
    assert np.abs(res.R - R).max() < 5e-2

    # fallback=False reports the uncertified seeding result instead.
    res2 = srv.register(source[None], fallback=False)[0]
    assert not res2.fallback_used
    assert not res2.certified


def test_mesh_sharded_matches_single(problem):
    """Pairs shard over the cubes mesh axis; per-pair results must match
    the unsharded call (lockstep lanes are masked per-pair, so sharding
    cannot change any pair's trajectory)."""
    import jax
    from fgoicp.parallel import sharding as psh
    pct, sources, _, _ = problem
    eng = std_engine(icp_multi_start=True)
    srv0 = serving.RegistrationService(pct, mse_threshold=1e-3, engine=eng)
    base = srv0.register(sources, fallback=False)
    mesh = psh.make_mesh(len(jax.devices()), 1)
    srv = serving.RegistrationService(pct, mse_threshold=1e-3, engine=eng,
                                      mesh=mesh)
    # 4 pairs over 8 devices exercises the pad-and-trim path too.
    sharded = srv.register(sources, fallback=False)
    for a, b in zip(base, sharded):
        assert a.certified == b.certified
        np.testing.assert_allclose(a.R, b.R, atol=1e-5)
        np.testing.assert_allclose(a.t, b.t, atol=1e-5)
        # Different batch tilings change the NN matmul reduction order;
        # near-zero SSEs agree only to f32 accumulation noise.
        np.testing.assert_allclose(a.sse, b.sse, rtol=1e-4, atol=1e-9)


def test_trimmed_serving(problem):
    """trim_fraction tolerates outlier contamination in the sources."""
    pct, sources, Rs, ts = problem
    rng = np.random.default_rng(3)
    noisy = sources.copy()
    n_out = 8
    noisy[:, :n_out] = rng.uniform(-2, 2, size=(len(noisy), n_out, 3))
    srv = serving.RegistrationService(
        pct, mse_threshold=1e-3, trim_fraction=0.15,
        engine=std_engine(icp_multi_start=True))
    results = srv.register(noisy)
    for r, R_true in zip(results, Rs):
        assert r.certified
        assert np.abs(r.R - R_true).max() < 5e-2


def test_seed_subsample_certifies(problem):
    """Seeding on a source subsample still certifies: rescore/polish run
    on the full clouds, so the subsample only changes which start wins."""
    pct, sources, Rs, ts = problem
    srv = serving.RegistrationService(
        pct, mse_threshold=1e-3, seed_subsample=56,
        engine=std_engine(icp_multi_start=True))
    results = srv.register(sources, fallback=False)
    for r, R_true in zip(results, Rs):
        assert r.certified
        assert np.abs(r.R - R_true).max() < 5e-2


def test_input_validation(problem):
    pct, sources, _, _ = problem
    srv = serving.RegistrationService(pct)
    with pytest.raises(ValueError, match=r"\[B, ns, 3\]"):
        srv.register(np.zeros((2, 5, 2), np.float32))
    with pytest.raises(ValueError, match="NaN"):
        bad = sources.copy()
        bad[0, 0, 0] = np.nan
        srv.register(bad)
    with pytest.raises(ValueError, match="target"):
        serving.RegistrationService(np.zeros((4, 2), np.float32))


def test_ragged_batch_certifies(problem):
    """Ragged [ns_i, 3] sources pad with zero-weight lanes — no point is
    discarded, each pair certifies against its own ns_i threshold, and
    recovery matches the equal-size path."""
    pct, *_ = problem
    rng = np.random.default_rng(5)
    clouds, Rs, ts = [], [], []
    for i, ns in enumerate((80, 55, 103)):
        idx = rng.choice(len(pct), size=ns, replace=False)
        R = _rot(rng.normal(size=3), rng.uniform(0.1, 0.5))
        t = rng.uniform(-0.2, 0.2, size=3).astype(np.float32)
        clouds.append((pct[idx] - t) @ R)
        Rs.append(R)
        ts.append(t)
    srv = serving.RegistrationService(pct, mse_threshold=1e-3,
                                      engine=std_engine(icp_multi_start=True))
    results = srv.register(clouds)
    for r, R_true, t_true, cl in zip(results, Rs, ts, clouds):
        assert r.certified
        assert np.abs(r.R - R_true).max() < 5e-2
        # World-frame check: R s + t must land on the target.
        mapped = cl @ np.asarray(r.R).T + np.asarray(r.t)
        d = np.min(np.linalg.norm(
            mapped[:, None, :] - pct[None, :, :], axis=-1), axis=1)
        assert float(np.mean(d ** 2)) < 1e-3


def test_ragged_skewed_seed_subsample(problem):
    """A tiny cloud in a skewed ragged batch with an active seeding
    subsample: the per-pair subsample must draw each pair's REAL rows —
    a shared index set drawn from the padded range seeded the small
    pair on zero-weight padding (and could draw an all-padding
    subsample: zero total weight => NaN Procrustes poses)."""
    pct, *_ = problem
    rng = np.random.default_rng(9)
    clouds, Rs, ts = [], [], []
    for ns in (24, 400):
        idx = rng.choice(len(pct), size=ns, replace=False)
        R = _rot(rng.normal(size=3), 0.3)
        t = rng.uniform(-0.1, 0.1, size=3).astype(np.float32)
        clouds.append((pct[idx] - t) @ R)
        Rs.append(R)
        ts.append(t)
    srv = serving.RegistrationService(
        pct, mse_threshold=1e-3, seed_subsample=64,
        engine=std_engine(icp_multi_start=True))
    results = srv.register(clouds)
    for r, R_true, cl in zip(results, Rs, clouds):
        assert np.all(np.isfinite(r.R)) and np.all(np.isfinite(r.t))
        assert np.isfinite(r.sse)
        mapped = cl @ np.asarray(r.R).T + np.asarray(r.t)
        d = np.min(np.linalg.norm(
            mapped[:, None, :] - pct[None, :, :], axis=-1), axis=1)
        assert float(np.mean(d ** 2)) < 1e-3


def test_ragged_rejects_trim(problem):
    pct, *_ = problem
    srv = serving.RegistrationService(pct, trim_fraction=0.2,
                                      engine=std_engine())
    with pytest.raises(ValueError, match="ragged"):
        srv.register([np.zeros((10, 3), np.float32),
                      np.zeros((12, 3), np.float32)])


def test_fallback_seed_handoff_and_shared_proxy(problem):
    """Fallback pairs hand the batched seeding pose to GoICP (no
    redundant 15-start sweep) and share one target coreset build."""
    pct, *_ = problem
    rng = np.random.default_rng(7)
    idx = rng.choice(len(pct), size=80, replace=False)
    R = _rot([0, 0, 1], np.pi * 0.95)
    t = np.asarray([0.1, -0.05, 0.04], np.float32)
    source = (pct[idx] - t) @ R
    srv = serving.RegistrationService(pct, mse_threshold=1e-3,
                                      engine=std_engine())
    res = srv.register(np.stack([source, source]))
    assert srv._fallback_proxy is not None  # built once, shared
    for r in res:
        assert r.fallback_used and r.certified
        assert np.abs(r.R - R).max() < 5e-2
        assert r.mse <= 1e-3
