"""Property tests for bound evaluation (ops/bounds.py) and the batched
inner BnB (ops/frontier.py).

Core Go-ICP invariants: for every rotation node (center R_c, half-span s_r)
and translation node (center t_c, half-span s_t),
    lb <= SSE(R', t')   for all R' in the rotation cube, t' in the cube
    ub >= SSE(R_c, t_c)
with fix_rot collapsing the rotation cube to its center.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from fgoicp.ops import bounds as bounds_ops
from fgoicp.ops import coreset as coreset_ops
from fgoicp.ops import distance_field as df_ops
from fgoicp.ops import frontier as frontier_ops
from fgoicp.ops import geometry as geo
from fgoicp.ops import nn as nn_ops


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    pct = rng.uniform(-1, 1, size=(150, 3)).astype(np.float32)
    pcs = rng.uniform(-0.8, 0.8, size=(60, 3)).astype(np.float32)
    return pct, pcs


def _sse(pct, pcs, R, t):
    return float(nn_ops.exact_sse(jnp.asarray(pct), jnp.asarray(pcs),
                                  jnp.asarray(R), jnp.asarray(t)))


class TestCoreset:
    def test_small_target_is_exact(self, problem):
        pct, _ = problem
        cs = coreset_ops.build(pct, size=1024)
        assert cs.points.shape[0] == len(pct)
        assert float(cs.eps) == 0.0

    def test_covering_radius_holds(self):
        rng = np.random.default_rng(1)
        pct = rng.uniform(-1, 1, size=(500, 3)).astype(np.float32)
        cs = coreset_ops.build(pct, size=64)
        d2 = np.asarray(nn_ops.nearest_sqdist(jnp.asarray(pct), cs.points))
        assert np.sqrt(d2.max()) <= float(cs.eps) + 1e-5

    def test_fps_spreads_points(self):
        rng = np.random.default_rng(2)
        pct = rng.uniform(-1, 1, size=(500, 3)).astype(np.float32)
        idx = np.asarray(coreset_ops.farthest_point_sample(jnp.asarray(pct), 32))
        assert len(np.unique(idx)) == 32


def _eval(backend, pcs, rot_xyz, rot_span, fix_rot, t_c, t_span, **kw):
    R = geo.quat_cube_to_matrix(jnp.asarray(rot_xyz))[None]
    lb, ub = bounds_ops.evaluate_bounds(
        backend, jnp.asarray(pcs), R, jnp.asarray([rot_span]),
        jnp.asarray([fix_rot]), jnp.asarray(t_c, jnp.float32)[None, None],
        jnp.asarray([[t_span]]), **kw)
    return float(lb[0, 0]), float(ub[0, 0])


class TestBoundValidity:
    @pytest.mark.parametrize("kind", ["exact", "proxy"])
    def test_ub_is_achievable_error(self, problem, kind):
        # ub >= SSE at the node center (fix_rot pass).
        pct, pcs = problem
        backend = bounds_ops.make_backend(pct, kind=kind, proxy_size=32)
        rng = np.random.default_rng(3)
        for _ in range(3):
            rot = rng.uniform(-0.4, 0.4, 3)
            t_c = rng.uniform(-0.3, 0.3, 3)
            lb, ub = _eval(backend, pcs, rot, 0.1, True, t_c, 0.1)
            R = np.asarray(geo.quat_cube_to_matrix(jnp.asarray(rot)))
            true_sse = _sse(pct, pcs, R, t_c)
            assert ub >= true_sse - 1e-3
            assert lb <= true_sse + 1e-3

    @pytest.mark.parametrize("kind", ["exact", "proxy"])
    def test_lb_below_all_in_node(self, problem, kind):
        # lb <= SSE(R', t') for sampled transforms inside the node.
        pct, pcs = problem
        backend = bounds_ops.make_backend(pct, kind=kind, proxy_size=32)
        rng = np.random.default_rng(4)
        rot_c = np.array([0.1, -0.2, 0.15])
        t_c = np.array([0.1, 0.05, -0.1])
        s_r, s_t = 0.15, 0.2
        lb, _ = _eval(backend, pcs, rot_c, s_r, False, t_c, s_t)
        for _ in range(10):
            rp = rot_c + rng.uniform(-s_r, s_r, 3)
            tp = t_c + rng.uniform(-s_t, s_t, 3)
            R = np.asarray(geo.quat_cube_to_matrix(jnp.asarray(rp, jnp.float32)))
            assert lb <= _sse(pct, pcs, R, tp) + 1e-3

    def test_lut_backend_matches_exact_on_fine_grid(self, problem):
        pct, pcs = problem
        bounds = np.stack([pct.min(0) - 0.1, pct.max(0) + 0.1], axis=-1)
        field = df_ops.build(pct, bounds, 0.02, builder="brute")
        # Raw (non-conservative) mode: this test measures how close the
        # bare trilinear lookup sits to exact NN on a fine grid.
        lut_b = bounds_ops.make_backend(pct, kind="lut", field=field,
                                        conservative=False)
        ex_b = bounds_ops.make_backend(pct, kind="exact")
        lb_l, ub_l = _eval(lut_b, pcs, [0.1, 0.0, 0.0], 0.1, True, [0.05, 0, 0], 0.1)
        lb_e, ub_e = _eval(ex_b, pcs, [0.1, 0.0, 0.0], 0.1, True, [0.05, 0, 0], 0.1)
        # Fine grid: LUT bounds close to exact (interp error ~res per point).
        assert abs(ub_l - ub_e) < 0.15 * len(pcs) * 0.02
        assert abs(lb_l - lb_e) < 0.15 * len(pcs) * 0.02

    def test_zero_span_bounds_bracket_tightly(self, problem):
        # span -> 0: lb and ub both converge to the exact SSE.
        pct, pcs = problem
        backend = bounds_ops.make_backend(pct, kind="exact")
        rot = [0.1, 0.2, -0.1]
        t_c = [0.05, -0.02, 0.1]
        lb, ub = _eval(backend, pcs, rot, 1e-6, False, t_c, 1e-6)
        R = np.asarray(geo.quat_cube_to_matrix(jnp.asarray(rot, jnp.float32)))
        true_sse = _sse(pct, pcs, R, t_c)
        assert lb == pytest.approx(true_sse, rel=1e-2, abs=1e-3)
        assert ub == pytest.approx(true_sse, rel=1e-2, abs=1e-3)

    def test_masked_lanes_return_big(self, problem):
        pct, pcs = problem
        backend = bounds_ops.make_backend(pct, kind="exact")
        R = jnp.broadcast_to(jnp.eye(3), (1, 3, 3))
        lb, ub = bounds_ops.evaluate_bounds(
            backend, jnp.asarray(pcs), R, jnp.asarray([0.1]),
            jnp.asarray([True]), jnp.zeros((1, 2, 3)), jnp.full((1, 2), 0.1),
            node_mask=jnp.asarray([[True, False]]))
        assert float(lb[0, 1]) >= 1e9 and float(ub[0, 1]) >= 1e9
        assert float(lb[0, 0]) < 1e9

    def test_trimmed_bounds_leq_full(self, problem):
        pct, pcs = problem
        backend = bounds_ops.make_backend(pct, kind="exact")
        full = _eval(backend, pcs, [0.3, 0, 0], 0.1, True, [0.2, 0, 0], 0.1)
        trim = _eval(backend, pcs, [0.3, 0, 0], 0.1, True, [0.2, 0, 0], 0.1,
                     trim_keep=int(len(pcs) * 0.8))
        assert trim[0] <= full[0] and trim[1] <= full[1]

    def test_dropsum_bracket_directions(self):
        """The bisection drop-sum brackets the exact top-k sum from the
        sound side (over >= exact >= under) and is tight to f32 ties —
        including zero terms, ties, -BIG padding sentinels, and n_drop
        exceeding the positive-entry count."""
        rng = np.random.default_rng(11)
        import jax.numpy as jnp
        for ns, k in [(257, 40), (64, 63), (128, 100)]:
            x = rng.uniform(0.0, 2.0, size=(5, ns)).astype(np.float32)
            x[:, ::7] = 0.0                        # zero terms
            x[:, 1] = x[:, 2]                      # exact tie
            x[0, 10:] = -1e30                      # padding sentinels
            xj = jnp.asarray(x)
            exact = np.sort(np.maximum(x, 0.0), axis=-1)[:, ::-1][:, :k].sum(-1)
            over = np.asarray(bounds_ops._dropsum_bracket(xj, k, "over"))
            under = np.asarray(bounds_ops._dropsum_bracket(xj, k, "under"))
            assert np.all(over >= exact - 1e-4), (over, exact)
            assert np.all(under <= exact + 1e-4), (under, exact)
            # Tight: both within a few f32 ulps of the true sum.
            np.testing.assert_allclose(over, exact, rtol=3e-5, atol=1e-4)
            np.testing.assert_allclose(under, exact, rtol=3e-5, atol=1e-4)

    def test_trimmed_bracket_matches_exact_reduction(self, problem):
        """End-to-end: the default (bisection) trimmed bounds bracket the
        exact top-k reduction — lb_bisect <= lb_exact, ub_bisect >=
        ub_exact — and coincide with it up to f32 ties."""
        pct, pcs = problem
        backend = bounds_ops.make_backend(pct, kind="exact")
        keep = int(len(pcs) * 0.7)
        lb_b, ub_b = _eval(backend, pcs, [0.3, 0, 0], 0.1, False,
                           [0.2, 0, 0], 0.1, trim_keep=keep)
        # Exact reference: recompute via the exact drop path.
        import jax.numpy as jnp
        from fgoicp.ops import geometry as geo2
        R = geo2.quat_cube_to_matrix(
            jnp.asarray([[0.3, 0, 0]], jnp.float32))
        q = (jnp.einsum("grc,nc->gnr", R, jnp.asarray(pcs, jnp.float32))
             + jnp.asarray([[0.2, 0, 0]], jnp.float32)[:, None, :])
        d_ub, d_lb = bounds_ops.distance_estimates(backend, q[:, None])
        norms = jnp.linalg.norm(jnp.asarray(pcs, jnp.float32), axis=-1)
        gub, glb = bounds_ops.gamma_arrays(
            norms, jnp.asarray([0.1], jnp.float32),
            jnp.asarray([False]))
        gt = geo2.translation_uncertainty_radius(
            jnp.asarray([[0.1]], jnp.float32))
        ub_pt = jnp.square(jnp.maximum(d_ub - gub[:, None, :], 0.0))
        lb_pt = jnp.square(jnp.maximum(
            d_lb - glb[:, None, :] - gt[:, :, None], 0.0))
        ub_e = bounds_ops.reduce_point_terms(ub_pt, None, keep, None)
        lb_e = bounds_ops.reduce_point_terms(lb_pt, None, keep, None)
        assert float(lb_b) <= float(lb_e[0, 0]) + 1e-4
        assert float(ub_b) >= float(ub_e[0, 0]) - 1e-4
        np.testing.assert_allclose(float(lb_b), float(lb_e[0, 0]),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(float(ub_b), float(ub_e[0, 0]),
                                   rtol=1e-4, atol=1e-4)


class TestInnerBnB:
    def test_finds_known_translation(self, problem):
        # Source = target shifted by t*: inner BnB (identity rotation, fixed)
        # must locate t ~= t* with near-zero ub.
        rng = np.random.default_rng(5)
        pct = rng.uniform(-0.6, 0.6, size=(120, 3)).astype(np.float32)
        t_star = np.array([0.35, -0.2, 0.1], np.float32)
        pcs = pct - t_star
        backend = bounds_ops.make_backend(pct, kind="exact")
        st = frontier_ops.bnb_r3_batched(
            backend, jnp.asarray(pcs), jnp.eye(3)[None],
            jnp.asarray([0.0]), jnp.asarray([True]),
            jnp.float32(1e10), jnp.float32(1e-3 * len(pcs)),
            batch=16, capacity=512, min_span=0.02)
        best_t = np.asarray(st.best_t[0])
        assert float(st.best_ub[0]) < 1e-3 * len(pcs) * 2
        np.testing.assert_allclose(best_t, t_star, atol=0.05)
        assert int(st.evaluated[0]) > 8
        assert not bool(st.active[0])

    def test_lb_pass_returns_rotation_lower_bound(self, problem):
        # fix_rot=False: returned best_ub is a valid LOWER bound on the
        # rotation node's optimal error: <= min over sampled t of SSE.
        pct, pcs = problem
        backend = bounds_ops.make_backend(pct, kind="exact")
        rot_c = np.array([0.2, 0.1, -0.1], np.float32)
        s_r = 0.1
        R = np.asarray(geo.quat_cube_to_matrix(jnp.asarray(rot_c)))
        st = frontier_ops.bnb_r3_batched(
            backend, jnp.asarray(pcs), jnp.asarray(R)[None],
            jnp.asarray([s_r]), jnp.asarray([False]),
            jnp.float32(1e10), jnp.float32(1e-3 * len(pcs)),
            batch=16, capacity=512)
        lb_val = float(st.best_ub[0])
        rng = np.random.default_rng(6)
        for _ in range(5):
            rp = rot_c + rng.uniform(-s_r, s_r, 3).astype(np.float32)
            Rp = np.asarray(geo.quat_cube_to_matrix(jnp.asarray(rp)))
            tp = rng.uniform(-1, 1, 3).astype(np.float32)
            assert lb_val <= _sse(pct, pcs, Rp, tp) + 1e-2

    def test_inactive_groups_untouched(self, problem):
        pct, pcs = problem
        backend = bounds_ops.make_backend(pct, kind="exact")
        R = jnp.broadcast_to(jnp.eye(3), (2, 3, 3))
        st = frontier_ops.bnb_r3_batched(
            backend, jnp.asarray(pcs), R, jnp.zeros(2),
            jnp.asarray([True, True]), jnp.float32(1e10), jnp.float32(0.1),
            group_active=jnp.asarray([True, False]), batch=8, capacity=128)
        assert int(st.evaluated[1]) == 0
        assert float(st.best_ub[1]) >= 1e9
