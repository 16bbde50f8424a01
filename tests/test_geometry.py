"""Unit tests for the SE(3) search-space geometry (ops/geometry.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

from fgoicp.ops import geometry as geo


def _random_unit_quat(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    if q[0] < 0:
        q = -q
    return q  # (w, x, y, z) with w >= 0


def _quat_to_matrix_np(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


class TestQuatCube:
    def test_identity(self):
        R = geo.quat_cube_to_matrix(jnp.zeros(3))
        np.testing.assert_allclose(np.asarray(R), np.eye(3), atol=1e-6)

    def test_matches_standard_quaternion(self):
        rng = np.random.default_rng(0)
        quats = np.stack([_random_unit_quat(rng) for _ in range(50)])
        R = np.asarray(geo.quat_cube_to_matrix(jnp.asarray(quats[:, 1:], jnp.float32)))
        expect = np.stack([_quat_to_matrix_np(q) for q in quats])
        np.testing.assert_allclose(R, expect, atol=1e-4)

    def test_orthonormal_det_one(self):
        rng = np.random.default_rng(1)
        xyz = rng.uniform(-0.57, 0.57, size=(64, 3)).astype(np.float32)
        R = np.asarray(geo.quat_cube_to_matrix(jnp.asarray(xyz)))
        eye = np.einsum("bij,bkj->bik", R, R)
        np.testing.assert_allclose(eye, np.broadcast_to(np.eye(3), eye.shape), atol=1e-5)
        np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-5)

    def test_rotation_angle_mapping(self):
        # |imag(q)| = sin(theta/2) -> rotation by theta around the axis.
        theta = 0.8
        xyz = jnp.asarray([np.sin(theta / 2), 0.0, 0.0])
        R = np.asarray(geo.quat_cube_to_matrix(xyz))
        # Rotation about x by theta.
        c, s = np.cos(theta), np.sin(theta)
        expect = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
        np.testing.assert_allclose(R, expect, atol=1e-6)


class TestSO3Membership:
    def test_in_so3(self):
        assert bool(geo.in_so3(jnp.asarray([0.5, 0.5, 0.5])))
        assert not bool(geo.in_so3(jnp.asarray([0.8, 0.8, 0.8])))

    def test_overlap_superset_of_membership(self):
        rng = np.random.default_rng(2)
        xyz = rng.uniform(-1.2, 1.2, size=(256, 3)).astype(np.float32)
        span = 0.25
        inside = np.asarray(geo.in_so3(jnp.asarray(xyz)))
        overlap = np.asarray(geo.overlaps_so3(jnp.asarray(xyz), span))
        assert np.all(overlap[inside])  # center inside ball => cube overlaps

    def test_overlap_rejects_far_cubes(self):
        assert not bool(geo.overlaps_so3(jnp.asarray([2.0, 2.0, 2.0]), 0.1))

    def test_overlap_exactness(self):
        # Brute-force check: nearest point of the cube to origin.
        rng = np.random.default_rng(3)
        c = rng.uniform(-1.5, 1.5, size=(200, 3)).astype(np.float32)
        s = np.float32(0.21)
        nearest = np.maximum(np.abs(c) - s, 0.0)
        truth = np.sum(nearest**2, axis=-1) <= 1.0
        got = np.asarray(geo.overlaps_so3(jnp.asarray(c), s))
        np.testing.assert_array_equal(got, truth)


class TestSplit:
    def test_split_octree_covers_parent(self):
        centers = jnp.asarray([[0.1, -0.2, 0.3]])
        spans = jnp.asarray([0.4])
        cc, cs = geo.split_octree(centers, spans)
        cc, cs = np.asarray(cc), np.asarray(cs)
        assert cc.shape == (1, 8, 3) and cs.shape == (1, 8)
        np.testing.assert_allclose(cs, 0.2)
        # Children centers at parent +- span/2 in each axis.
        for j in range(8):
            expect = np.array([0.1, -0.2, 0.3]) + 0.2 * np.array(
                [1 if (j >> k) & 1 else -1 for k in range(3)])
            assert any(np.allclose(cc[0, i], expect, atol=1e-6) for i in range(8))
        # Reference child construction (fgoicp.cpp:54-59): parent - s + bit*2s.
        ref_children = []
        for j in range(8):
            ref_children.append([
                0.1 - 0.2 + ((j >> 0) & 1) * 0.4,
                -0.2 - 0.2 + ((j >> 1) & 1) * 0.4,
                0.3 - 0.2 + ((j >> 2) & 1) * 0.4,
            ])
        np.testing.assert_allclose(np.sort(cc[0], axis=0),
                                   np.sort(np.array(ref_children), axis=0),
                                   atol=1e-6)


class TestUncertainty:
    def test_gamma_t(self):
        np.testing.assert_allclose(
            float(geo.translation_uncertainty_radius(0.5)),
            np.sqrt(3) * 0.5, rtol=1e-6)

    def test_gamma_r_correct_mode_upper_bounds_displacement(self):
        # For any rotation R' with cube coords within span of the center,
        # |R' p - R p| <= gamma_r(|p|, span).  Sample-check at the identity.
        rng = np.random.default_rng(4)
        span = 0.1
        p = rng.uniform(-1, 1, size=(64, 3)).astype(np.float32)
        p /= np.maximum(1.0, np.linalg.norm(p, axis=1, keepdims=True))
        norms = np.linalg.norm(p, axis=1)
        gam = np.asarray(geo.rotation_uncertainty_radius(
            jnp.asarray(norms), span, ref_compat=False))
        d = rng.uniform(-span, span, size=(20, 3)).astype(np.float32)
        R = np.asarray(geo.quat_cube_to_matrix(jnp.asarray(d)))  # [20, 3, 3]
        disp = np.linalg.norm(np.einsum("kij,nj->kni", R, p) - p, axis=-1)
        assert np.all(disp <= gam[None, :] + 1e-5)

    def test_gamma_r_ref_compat_formula(self):
        # registration.cu:39-43: 2 * |p|^2 * sin(span * sqrt(3) * pi / 2).
        span, norm = 0.2, 0.7
        got = float(geo.rotation_uncertainty_radius(
            jnp.asarray(norm), span, ref_compat=True))
        expect = 2 * norm**2 * np.sin(span * np.sqrt(3) * np.pi / 2)
        np.testing.assert_allclose(got, expect, rtol=1e-6)


class TestNormalization:
    def test_normalize_and_restore(self):
        rng = np.random.default_rng(5)
        pct = rng.normal(size=(100, 3)).astype(np.float32) * 2 + 1.0
        pcs = rng.normal(size=(80, 3)).astype(np.float32) * 3 - 0.5
        norm = geo.Normalization(pct, pcs)
        # Source fits in [-1, 1].
        assert float(jnp.max(jnp.abs(norm.pcs))) <= 1.0 + 1e-6
        np.testing.assert_allclose(
            np.asarray(jnp.mean(norm.pcs, axis=0)) * 0, 0, atol=1e-5)
        # restore_translation: if R, t align normalized clouds, the restored
        # t aligns the originals.  Construct a known world transform.
        R = _quat_to_matrix_np(_random_unit_quat(rng)).astype(np.float32)
        t_world = rng.normal(size=3).astype(np.float32)
        # normalized: y = s*(x_t + off_t); x_t = R x_s + t_w
        # => y = R (s (x_s + off_s)) + s*(t_w + R*(-off_s) ... derive via code:
        # norm target point for source x: s*(R x + t_w + off_t)
        # transformed norm source: R*(s*(x+off_s)) + t_n
        # equal iff t_n = s*(t_w + off_t - R off_s)  [off = -centroid]
        s = float(norm.scale)
        off_s, off_t = np.asarray(norm.offset_pcs), np.asarray(norm.offset_pct)
        t_n = s * (t_world + off_t - R @ off_s)
        restored = np.asarray(norm.restore_translation(R, jnp.asarray(t_n)))
        np.testing.assert_allclose(restored, t_world, atol=1e-4)
