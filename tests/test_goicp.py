"""End-to-end Go-ICP tests: ground-truth recovery where plain ICP fails.

Mirrors the reference's implicit test strategy (SURVEY §4): synthetic pairs
with a known (R, t) generated like scripts/transform_point_cloud.py, but
seeded and asserted automatically.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from fgoicp.config import Config
from util import std_engine
from fgoicp.models.goicp import GoICP, register


def _surface_cloud(rng, n, noise=0.01):
    """Structured asymmetric cloud: real scans have surface structure, so
    BnB bounds discriminate; uniform volume noise (and symmetric shapes
    like spheres) are Go-ICP's worst case and made these tests 100x
    slower."""
    # 3D Lissajous curve: strongly asymmetric (no rotational ambiguity),
    # structured like scan data -> BnB bounds discriminate fast.
    s = rng.uniform(0.0, 4.5, size=(n,))  # open curve: no self-symmetry
    pts = np.stack([np.cos(s), 0.7 * np.sin(2.0 * s),
                    0.4 * np.sin(3.0 * s + 0.5)], axis=1)
    pts = pts + rng.normal(scale=noise, size=(n, 3))
    return pts.astype(np.float32)


def _make_problem(seed=0, n=160, angle=2.0):
    rng = np.random.default_rng(seed)
    pct = _surface_cloud(rng, n)
    c, s = np.cos(angle), np.sin(angle)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    t = np.array([0.2, -0.1, 0.15], np.float32)
    pcs = (pct - t) @ R  # so that R @ pcs + t == pct
    return pct, pcs, R, t


class TestGoICP:
    @pytest.mark.parametrize("backend", ["exact", "proxy"])
    def test_recovers_large_rotation(self, backend):
        pct, pcs, R_true, t_true = _make_problem(angle=2.2)
        model = GoICP(pct, pcs, mse_threshold=5e-4,
                      engine=std_engine(),
                      bound_backend=backend, proxy_size=128)
        R, t = model.run()
        assert model.mse < 5e-4
        np.testing.assert_allclose(R, R_true, atol=1e-3)
        np.testing.assert_allclose(t, t_true, atol=1e-3)
        assert model.stats.translation_nodes > 0
        assert model.stats.rotation_children > 0

    def test_world_frame_restoration(self):
        # Un-normalized clouds with big offsets/scales: returned (R, t)
        # must map the ORIGINAL source onto the ORIGINAL target.
        pct, pcs, R_true, t_true = _make_problem(seed=1, angle=1.5)
        pct_w = pct * 37.0 + np.array([100.0, -50.0, 3.0], np.float32)
        pcs_w = pcs * 37.0 + np.array([-8.0, 2.0, 77.0], np.float32)
        model = GoICP(pct_w, pcs_w, mse_threshold=5e-4,
                      engine=std_engine(),
                      bound_backend="exact")
        R, t = model.run()
        mapped = pcs_w @ np.asarray(R).T + np.asarray(t)
        rmse = np.sqrt(np.mean(np.sum((mapped - pct_w) ** 2, axis=1)))
        assert rmse < 37.0 * 0.02  # 2% of scale

    def test_getters_match_reference_surface(self):
        pct, pcs, _, _ = _make_problem(seed=2, angle=0.3)
        model = GoICP(pct, pcs, mse_threshold=1e-3,
                      engine=std_engine(),
                      bound_backend="exact")
        model.run()
        err = model.get_best_error()
        R, t = model.get_best_transform()
        lR, lt = model.get_last_transform()
        assert err == model.best_sse
        assert R.shape == (3, 3) and t.shape == (3,)
        assert lR.shape == (3, 3) and lt.shape == (3,)

    def test_register_from_config(self, tmp_path):
        pct, pcs, R_true, t_true = _make_problem(seed=3, angle=1.0)
        tpath, spath = tmp_path / "t.txt", tmp_path / "s.txt"
        for path, pc in [(tpath, pct), (spath, pcs)]:
            with open(path, "w") as f:
                f.write(f"{len(pc)}\n")
                np.savetxt(f, pc, fmt="%.6f")
        cfg = Config.from_dict({
            "io": {"target": str(tpath), "source": str(spath)},
            "params": {"mse_threshold": 5e-4,
                       "target_subsample": 1.0, "source_subsample": 0.5},
            "engine": {"rotation_batch": 2, "frontier_capacity": 512,
                       "pool_lanes": 256, "pool_capacity": 8192},
        })
        model, R, t = register(cfg)
        # source_subsample clamps to 0.5 -> half the source points used;
        # the recovered transform still matches.
        np.testing.assert_allclose(R, R_true, atol=5e-3)
        np.testing.assert_allclose(t, t_true, atol=5e-3)

    def test_ref_compat_gamma_mode(self):
        # The reference's rotation-radius variant (squared norm, unclamped
        # half-angle, registration.cu:39-43) must work through the whole
        # pipeline, not just the formula test.
        pct, pcs, R_true, t_true = _make_problem(seed=6, angle=2.1)
        model = GoICP(pct, pcs, mse_threshold=5e-4,
                      engine=std_engine(ref_compat_gamma=True),
                      bound_backend="exact")
        R, t = model.run()
        np.testing.assert_allclose(R, R_true, atol=1e-3)
        np.testing.assert_allclose(t, t_true, atol=1e-3)

    def test_production_config_certificate(self):
        """Run the EXACT production search configuration — reference span
        cutoffs 0.05/0.1 and the 1.8 ICP trigger (fgoicp.cpp:53,74,155),
        multi-start off so the BnB does the work — and assert ground-truth
        recovery plus evidence that the certificate machinery actually
        engaged (at least one outer prune; the trigger made a non-trivial
        decision).  Round-1 gap: the suite only exercised coarse spans +
        an always-on trigger, so a production-path bug was invisible."""
        from fgoicp.config import EngineConfig
        pct, pcs, R_true, t_true = _make_problem(seed=9, angle=2.0, n=120)
        # Per-point noise on the source makes the optimum strictly
        # positive; with a threshold below the noise floor the gap can
        # never close for free, so the BnB must certify by PRUNING the
        # rotation tree (lb >= best_sse) down to the span cutoffs.
        rng = np.random.default_rng(10)
        pcs = pcs + rng.normal(scale=0.008, size=pcs.shape).astype(np.float32)
        eng = EngineConfig(
            rotation_batch=2, pool_lanes=64, pool_capacity=4096,
            icp_multi_start=False)
        # Production search semantics must be the dataclass defaults.
        assert eng.rotation_min_span == 0.05
        assert eng.translation_min_span == 0.1
        assert eng.icp_trigger_factor == 1.8
        model = GoICP(pct, pcs, mse_threshold=1e-5, engine=eng,
                      bound_backend="exact")
        R, t = model.run()
        assert model.mse < 3e-4  # noise floor ~ sigma^2 * 3
        np.testing.assert_allclose(R, R_true, atol=5e-3)
        np.testing.assert_allclose(t, t_true, atol=5e-3)
        s = model.stats
        assert s.rotation_pruned > 0, "no outer-cube prune ever fired"
        assert s.icp_triggered > 0, "the 1.8x trigger never fired"
        assert s.icp_triggered < s.rotation_children, \
            "trigger fired for every child (trivial decision)"
        assert s.translation_nodes > 0

    def test_lut_backend_end_to_end(self):
        # Default (sound, conservative) LUT engine recovers ground truth.
        pct, pcs, R_true, t_true = _make_problem(seed=7, angle=1.7)
        model = GoICP(pct, pcs, lut_resolution=0.05, mse_threshold=5e-4,
                      engine=std_engine(), bound_backend="lut")
        assert model.backend.conservative and not model.backend.ref_compat
        R, t = model.run()
        np.testing.assert_allclose(R, R_true, atol=1e-3)
        np.testing.assert_allclose(t, t_true, atol=1e-3)

    def test_ref_compat_lut_end_to_end(self):
        # The reference-exact LUT mode (d^2 texture, half-texel shift,
        # registration.cu:214-234,320-328) through the whole pipeline.
        pct, pcs, R_true, t_true = _make_problem(seed=8, angle=1.6)
        model = GoICP(pct, pcs, lut_resolution=0.05, mse_threshold=5e-4,
                      engine=std_engine(ref_compat_lut=True),
                      bound_backend="lut")
        assert model.backend.ref_compat and not model.backend.conservative
        R, t = model.run()
        np.testing.assert_allclose(R, R_true, atol=2e-3)
        np.testing.assert_allclose(t, t_true, atol=2e-3)

    def test_trimmed_registration_with_outliers(self):
        # 20% of source points are garbage; trimming must still recover.
        pct, pcs, R_true, t_true = _make_problem(seed=4, angle=1.8, n=200)
        rng = np.random.default_rng(5)
        n_out = 40
        outliers = rng.uniform(-3, 3, size=(n_out, 3)).astype(np.float32)
        pcs_noisy = np.concatenate([pcs, outliers])
        model = GoICP(pct, pcs_noisy, mse_threshold=5e-4,
                      engine=std_engine(),
                      bound_backend="exact", trim_fraction=0.25)
        R, t = model.run()
        np.testing.assert_allclose(R, R_true, atol=0.05)
        np.testing.assert_allclose(t, t_true, atol=0.05)


class TestDeviceOuterMode:
    def test_device_outer_matches_host(self):
        """outer_mode='device' (one jitted nested-BnB call,
        ops/so3_frontier.py) must reach the same optimum as the host
        heap on the same problem."""
        pct, pcs, R_true, t_true = _make_problem(seed=12, angle=2.0)
        host = GoICP(pct, pcs, mse_threshold=5e-4, engine=std_engine(),
                     bound_backend="exact")
        host.run()
        dev = GoICP(pct, pcs, mse_threshold=5e-4,
                    engine=std_engine(outer_mode="device",
                                      so3_capacity=2048),
                    bound_backend="exact")
        R, t = dev.run()
        assert dev.mse < 5e-4
        np.testing.assert_allclose(R, R_true, atol=1e-3)
        np.testing.assert_allclose(t, t_true, atol=1e-3)
        # Same optimum as the host loop (scheduling differs, basin same).
        assert abs(dev.best_sse - host.best_sse) <= \
            1e-3 * max(host.best_sse, 1e-9) + 1e-9
        assert dev.stats.outer_steps > 0
        assert dev.stats.translation_nodes > 0
        # Device mode records incumbent history (the ring in SO3State is
        # folded into model.history): non-empty, non-increasing sse,
        # ending at the final optimum.
        assert len(dev.history) >= 1
        sses = [h[1] for h in dev.history]
        assert all(b <= a + 1e-6 for a, b in zip(sses, sses[1:]))
        np.testing.assert_allclose(sses[-1], dev.best_sse, rtol=1e-6)

    def test_device_outer_rejects_unsupported(self):
        import pytest
        pct, pcs, _, _ = _make_problem(seed=13, angle=0.5)
        with pytest.raises(ValueError, match="outer_mode"):
            GoICP(pct, pcs, engine=std_engine(outer_mode="banana"))

    def test_device_outer_overflow_falls_back_to_host(self):
        """A tiny SO(3) frontier forces subtree drops; the device search
        then ends with an OPEN certificate gap and the engine must
        re-certify via the host loop — still returning the optimum."""
        pct, pcs, R_true, t_true = _make_problem(seed=14, angle=2.2)
        m = GoICP(pct, pcs, mse_threshold=5e-4,
                  engine=std_engine(outer_mode="device", so3_capacity=16,
                                    icp_multi_start=False),
                  bound_backend="exact")
        R, t = m.run()
        assert m.mse < 5e-4
        np.testing.assert_allclose(R, R_true, atol=1e-3)
        np.testing.assert_allclose(t, t_true, atol=1e-3)

    @pytest.mark.parametrize("mode", ["host", "device"])
    def test_exhaustion_reports_open_gap(self, mode):
        """Soundness regression (r5 bun090 class): an UNREACHABLE mse
        threshold forces the finite rotation tree to exhaust; closing
        terminal leaves whose lb still claims improvement must hold
        last_certified_gap OPEN (closed_lb / _closed_leaf_lb fold) —
        before the fix, exhaustion read as an exhaustive certificate
        and a wrong 'global' optimum shipped silently."""
        rng = np.random.default_rng(21)
        pct = _surface_cloud(rng, 160)
        # Noisy rotated subset: achievable mse ~ noise^2 >> threshold.
        c, s = np.cos(1.3), np.sin(1.3)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        pcs = ((pct[:120] - 0.1) @ R
               + rng.normal(scale=0.02, size=(120, 3))).astype(np.float32)
        m = GoICP(pct, pcs, mse_threshold=1e-9,
                  engine=std_engine(outer_mode=mode,
                                    rotation_min_span=0.3,
                                    icp_trigger_factor=1.8,
                                    icp_multi_start=False),
                  bound_backend="exact")
        m.run()
        assert m.last_certified_gap is not None
        assert m.last_certified_gap > m.sse_threshold
        assert m.best_sse < 1e10  # still returns the best incumbent

    def test_device_outer_capacity_guard(self):
        import pytest
        pct, pcs, _, _ = _make_problem(seed=15, angle=0.4)
        m = GoICP(pct, pcs, mse_threshold=5e-4,
                  engine=std_engine(outer_mode="device", so3_capacity=8),
                  bound_backend="exact")
        with pytest.raises(ValueError, match="so3 capacity"):
            m.run()

    def test_device_outer_with_lut_backend(self):
        """Device outer mode composes with the (sound, conservative) LUT
        backend — the inner pool's XLA fallback path inside the fused
        while_loop."""
        pct, pcs, R_true, t_true = _make_problem(seed=16, angle=1.9)
        m = GoICP(pct, pcs, lut_resolution=0.05, mse_threshold=5e-4,
                  engine=std_engine(outer_mode="device", so3_capacity=2048),
                  bound_backend="lut")
        R, t = m.run()
        assert m.mse < 5e-4
        np.testing.assert_allclose(R, R_true, atol=1e-3)
        np.testing.assert_allclose(t, t_true, atol=1e-3)
