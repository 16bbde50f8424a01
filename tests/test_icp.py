"""Tests for Procrustes (ops/procrustes.py) and batched ICP (models/icp.py)."""

import jax.numpy as jnp
import numpy as np

from fgoicp.models import icp as icp_model
from fgoicp.ops import procrustes as proc


def _random_rotation(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], dtype=np.float32)


class TestClosestRotation:
    def test_recovers_exact_rotation(self):
        rng = np.random.default_rng(0)
        for _ in range(20):
            R = _random_rotation(rng)
            a = rng.normal(size=(30, 3)).astype(np.float32)
            b = a @ R.T
            abt = a.T @ b  # sum a_i b_i^T
            got = np.asarray(proc.closest_rotation(jnp.asarray(abt)))
            np.testing.assert_allclose(got, R, atol=1e-4)

    def test_reflection_fix(self):
        # A reflection-dominant covariance must still yield det=+1.
        abt = np.diag([1.0, 1.0, -1.0]).astype(np.float32)
        R = np.asarray(proc.closest_rotation(jnp.asarray(abt)))
        np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-5)

    def test_batched(self):
        rng = np.random.default_rng(1)
        Rs = np.stack([_random_rotation(rng) for _ in range(5)])
        a = rng.normal(size=(5, 20, 3)).astype(np.float32)
        b = np.einsum("gij,gnj->gni", Rs, a)
        abt = np.einsum("gnr,gnc->grc", a, b)
        got = np.asarray(proc.closest_rotation(jnp.asarray(abt)))
        np.testing.assert_allclose(got, Rs, atol=1e-4)


class TestProcrustes:
    def test_exact_correspondence_recovery(self):
        rng = np.random.default_rng(2)
        R = _random_rotation(rng)
        t = rng.normal(size=3).astype(np.float32)
        src = rng.normal(size=(50, 3)).astype(np.float32)
        corr = src @ R.T + t
        Rg, tg = proc.procrustes(jnp.asarray(src), jnp.asarray(corr))
        np.testing.assert_allclose(np.asarray(Rg), R, atol=2e-3)
        np.testing.assert_allclose(np.asarray(tg), t, atol=2e-3)

    def test_masked(self):
        rng = np.random.default_rng(3)
        R = _random_rotation(rng)
        t = np.array([0.3, -0.2, 0.1], np.float32)
        src = rng.normal(size=(40, 3)).astype(np.float32)
        corr = src @ R.T + t
        corr[30:] += 100.0  # corrupt the tail
        mask = np.ones(40, np.float32)
        mask[30:] = 0.0
        Rg, tg = proc.procrustes(jnp.asarray(src), jnp.asarray(corr),
                                 mask=jnp.asarray(mask))
        np.testing.assert_allclose(np.asarray(Rg), R, atol=2e-3)
        np.testing.assert_allclose(np.asarray(tg), t, atol=2e-3)


class TestICP:
    def _make_pair(self, rng, n=200, angle=0.2, t_scale=0.05):
        pct = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
        c, s = np.cos(angle), np.sin(angle)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        t = (rng.normal(size=3) * t_scale).astype(np.float32)
        # source such that R_true @ src + t_true = pct
        src = (pct - t) @ R  # R^T applied => R @ src + t = pct
        return pct, src, R, t

    def test_converges_to_ground_truth(self):
        rng = np.random.default_rng(4)
        pct, src, R, t = self._make_pair(rng)
        sse, Rg, tg = icp_model.icp_register(
            jnp.asarray(pct), jnp.asarray(src),
            max_iter=100, convergence_threshold=1e-6)
        assert float(sse) < 1e-4
        np.testing.assert_allclose(np.asarray(Rg), R, atol=1e-2)
        np.testing.assert_allclose(np.asarray(tg), t, atol=1e-2)

    def test_batched_lanes_independent(self):
        rng = np.random.default_rng(5)
        pct, src, R, t = self._make_pair(rng)
        R0 = jnp.stack([jnp.eye(3), jnp.asarray(R)])
        t0 = jnp.stack([jnp.zeros(3), jnp.asarray(t)])
        sse, Rg, tg = icp_model.icp_batched(
            jnp.asarray(pct), jnp.asarray(src), R0, t0,
            max_iter=100, convergence_threshold=1e-6)
        # Lane 1 starts at the answer; both lanes should end near zero error
        # (floor set by one f32 Procrustes step away from the exact optimum).
        assert float(sse[1]) < 1e-4
        assert float(sse[0]) < 1e-4

    def test_inactive_lane_untouched(self):
        rng = np.random.default_rng(6)
        pct, src, _, _ = self._make_pair(rng)
        R0 = jnp.stack([jnp.eye(3), jnp.eye(3)])
        t0 = jnp.zeros((2, 3))
        active = jnp.asarray([True, False])
        sse, Rg, tg = icp_model.icp_batched(
            jnp.asarray(pct), jnp.asarray(src), R0, t0, active=active,
            max_iter=50, convergence_threshold=1e-6)
        # Inactive lane returns its initial state with sentinel error.
        assert float(sse[1]) >= 1e9
        np.testing.assert_allclose(np.asarray(Rg[1]), np.eye(3), atol=1e-6)

    def test_zero_iteration_identity_pair(self):
        # Identical clouds: ICP should stay at identity with ~zero SSE.
        rng = np.random.default_rng(7)
        pc = rng.normal(size=(100, 3)).astype(np.float32)
        sse, Rg, tg = icp_model.icp_register(
            jnp.asarray(pc), jnp.asarray(pc), max_iter=10,
            convergence_threshold=0.005)
        assert float(sse) < 1e-6
        np.testing.assert_allclose(np.asarray(Rg), np.eye(3), atol=1e-3)


class TestExactSse:
    def test_matches_manual_sse(self):
        rng = np.random.default_rng(7)
        pct = jnp.asarray(rng.uniform(-1, 1, (90, 3)), jnp.float32)
        pcs = jnp.asarray(rng.uniform(-1, 1, (40, 3)), jnp.float32)
        R = jnp.stack([jnp.asarray(_random_rotation(rng)) for _ in range(3)])
        t = jnp.asarray(rng.uniform(-0.2, 0.2, (3, 3)), jnp.float32)
        got = np.asarray(icp_model.exact_sse_batched(pct, pcs, R, t))
        for g in range(3):
            cur = np.asarray(pcs) @ np.asarray(R[g]).T + np.asarray(t[g])
            d2 = ((cur[:, None, :] - np.asarray(pct)[None]) ** 2).sum(-1)
            expect = d2.min(axis=1).sum()
            np.testing.assert_allclose(got[g], expect, rtol=1e-5)

    def test_trimmed(self):
        rng = np.random.default_rng(8)
        pct = jnp.asarray(rng.uniform(-1, 1, (50, 3)), jnp.float32)
        pcs = jnp.asarray(rng.uniform(-1, 1, (20, 3)), jnp.float32)
        R = jnp.eye(3)[None]
        t = jnp.zeros((1, 3))
        got = float(icp_model.exact_sse_batched(pct, pcs, R, t,
                                                trim_keep=15)[0])
        d2 = ((np.asarray(pcs)[:, None] - np.asarray(pct)[None]) ** 2) \
            .sum(-1).min(axis=1)
        np.testing.assert_allclose(got, np.sort(d2)[:15].sum(), rtol=1e-5)


class TestSearchOnProxyInvariant:
    def test_incumbent_sse_is_exact(self):
        """With search ICPs iterating on the proxy coreset, the engine's
        claimed best_sse must still equal the EXACT full-target SSE of
        the returned pose (the certificate depends on it)."""
        import sys
        sys.path.insert(0, "/root/repo/tests")
        from util import std_engine
        from fgoicp.models.goicp import GoICP
        rng = np.random.default_rng(9)
        s = rng.uniform(0.0, 4.5, size=(200,))
        pct = np.stack([np.cos(s), 0.7 * np.sin(2 * s),
                        0.4 * np.sin(3 * s + 0.5)], axis=1).astype(np.float32)
        ang = 1.2
        c0, s0 = np.cos(ang), np.sin(ang)
        R_true = np.array([[c0, -s0, 0], [s0, c0, 0], [0, 0, 1]], np.float32)
        t_true = np.array([0.1, -0.05, 0.08], np.float32)
        pcs = (pct[:120] - t_true) @ R_true
        m = GoICP(pct, pcs, mse_threshold=5e-4,
                  engine=std_engine(icp_search_on_proxy=True),
                  bound_backend="proxy", proxy_size=64)
        assert m._icp_search_target is not None  # proxy < target: active
        m.run()
        exact = float(icp_model.exact_sse_batched(
            m.pct, m.pcs, jnp.asarray(m.best_rotation)[None],
            jnp.asarray(m.best_translation)[None])[0])
        np.testing.assert_allclose(m.best_sse, exact, rtol=1e-4, atol=1e-7)


def test_auto_source_coreset_rule():
    from fgoicp.config import EngineConfig
    from fgoicp.models.goicp import GoICP
    rng = np.random.default_rng(10)
    # Small source: auto keeps clusters OFF.
    pct = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    pcs = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    m = GoICP(pct, pcs, engine=EngineConfig())
    assert m.src_clusters is None
    # Large source: auto builds K = 2^round(log2(ns/3)) clusters.
    pcs_big = rng.uniform(-1, 1, (3000, 3)).astype(np.float32)
    m2 = GoICP(pct, pcs_big, engine=EngineConfig())
    assert m2.src_clusters is not None
    assert m2.src_clusters.reps.shape[0] == 1024
    # Explicit 0 disables; explicit K wins over auto.
    m3 = GoICP(pct, pcs_big, engine=EngineConfig(source_coreset=0))
    assert m3.src_clusters is None
    m4 = GoICP(pct, pcs_big, engine=EngineConfig(source_coreset=512))
    assert m4.src_clusters.reps.shape[0] == 512
