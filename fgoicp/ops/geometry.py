"""SE(3) search-space geometry: quaternion-cube rotations, SO(3) tests,
octree node splitting, cloud normalization.

Math parity with the reference (/root/reference/fgoicp/common.hpp:30-128,
fgoicp.cpp:176-287), written as batched jnp functions so whole frontiers of
nodes are processed in one compiled op (the reference handles one node at a
time on the host).

Convention note: the reference builds the standard quaternion rotation
matrix but stores it through glm's column-major ctor, so it actually applies
R(q)^T = R(q^{-1}) to points (common.hpp:50-54).  Because the quaternion
cube is symmetric under q -> q^{-1} (negating x,y,z), the searched rotation
set is identical; we use the standard R(q) so the cube coordinate of the
optimum negates relative to the reference while the optimal matrix set is
the same.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

SQRT3 = 1.7320508075688772


def quat_cube_to_matrix(xyz):
    """Map quaternion-imaginary cube coordinates [..., 3] to rotation
    matrices [..., 3, 3].

    w = sqrt(max(1 - |xyz|^2, 0)); coordinates outside the unit ball produce
    a best-effort matrix (callers must mask by `in_so3`).  Reference:
    common.hpp:37-57.
    """
    xyz = jnp.asarray(xyz)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    r2 = x * x + y * y + z * z
    ww = jnp.maximum(1.0 - r2, 0.0)
    w = jnp.sqrt(ww)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    row0 = jnp.stack([ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy)], axis=-1)
    row1 = jnp.stack([2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx)], axis=-1)
    row2 = jnp.stack([2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def in_so3(xyz):
    """Cube coordinate lies inside the closed unit ball (common.hpp:68)."""
    xyz = jnp.asarray(xyz)
    return jnp.sum(xyz * xyz, axis=-1) <= 1.0


def overlaps_so3(xyz, span):
    """Conservative cube-vs-unit-ball overlap test.

    (|x|-s)^2 + (|y|-s)^2 + (|z|-s)^2 <= 1, expanded.  The reference's
    expansion (common.hpp:99-103) reuses a field that holds the norm (not
    the squared norm) for in-ball centers; we use the squared norm, which is
    the correct expansion, so this test is slightly less conservative than
    the reference for in-ball centers (where the test is vacuous anyway:
    center inside the ball implies overlap).
    """
    xyz = jnp.asarray(xyz)
    r2 = jnp.sum(xyz * xyz, axis=-1)
    abs_sum = jnp.sum(jnp.abs(xyz), axis=-1)
    return r2 - 2.0 * span * abs_sum + 3.0 * span * span <= 1.0


# Child-offset signs for octree splitting: child j's center is
# parent - span/2 + (bit pattern of j) * span, i.e. parent +- span/2 per
# axis (fgoicp.cpp:54-59,159-168).
_CHILD_SIGNS = np.array(
    [[(j >> 0) & 1, (j >> 1) & 1, (j >> 2) & 1] for j in range(8)],
    dtype=np.float32,
) * 2.0 - 1.0  # [8, 3] in {-1, +1}


def split_octree(centers, spans):
    """Split nodes [..., 3] with half-spans [...] into 8 children.

    Returns (child_centers [..., 8, 3], child_spans [..., 8]).
    """
    centers = jnp.asarray(centers)
    spans = jnp.asarray(spans)
    half = spans[..., None] * 0.5
    # child center = parent + sign * span/2 for each axis
    child_centers = centers[..., None, :] + jnp.asarray(_CHILD_SIGNS) * half[..., None]
    child_spans = jnp.broadcast_to((spans * 0.5)[..., None], child_centers.shape[:-1])
    return child_centers, child_spans


def rotation_uncertainty_radius(point_norms, span, ref_compat: bool = False):
    """Per-point rotation uncertainty radius gamma_r for a rotation cube of
    half-span `span`.

    Correct form (Go-ICP paper, eq. 6): 2 * sin(min(half_angle, pi/2)) * |p|
    with half_angle = span * sqrt(3) * pi / 2 under the reference's
    quaternion-cube angle mapping.  ref_compat reproduces the reference's
    variant (registration.cu:39-43): squared norm, no clamp.
    """
    half_angle = span * SQRT3 * (jnp.pi / 2.0)
    if ref_compat:
        return 2.0 * (point_norms * point_norms) * jnp.sin(half_angle)
    return 2.0 * point_norms * jnp.sin(jnp.minimum(half_angle, jnp.pi / 2.0))


def translation_uncertainty_radius(span):
    """gamma_t = sqrt(3) * span (registration.cu:33)."""
    return SQRT3 * span


def multi_start_cube_coords() -> np.ndarray:
    """Quaternion-cube coordinates of the 14 non-identity ICP seed starts:
    the 8 rotation-cube octant centers plus the 6 face centers (the ±90°
    rotations about each axis).  Scan pairs routinely sit a quarter-turn
    apart, so a face-center start often lands the global basin and the
    whole BnB collapses to a gap check (models/goicp.py:_initial_icp;
    the reference seeds from identity only, fgoicp.cpp:12-14).
    """
    octants = [[sx * 0.5, sy * 0.5, sz * 0.5]
               for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
    r = 1.0 / np.sqrt(2.0)  # quaternion cube coordinate of a 90° turn
    faces = [[s * r if a == ax else 0.0 for a in range(3)]
             for ax in range(3) for s in (-1, 1)]
    return np.asarray(octants + faces, np.float32)


def multi_start_rotations(include_identity: bool = True) -> np.ndarray:
    """[S, 3, 3] seed rotation matrices for the multi-start sweeps --
    THE one builder every sweep shares (goicp._initial_icp stages,
    serving.start_rotations): a future change to the start set must not
    leave the serving-fallback cascade sweeping a different set than
    fresh runs."""
    R = np.asarray(quat_cube_to_matrix(
        jnp.asarray(multi_start_cube_coords())), np.float32)
    if include_identity:
        R = np.concatenate([np.eye(3, dtype=np.float32)[None], R])
    return R


# ---------------------------------------------------------------------------
# Cloud normalization (fgoicp.cpp:176-287, fgoicp.hpp:87-90)
# ---------------------------------------------------------------------------


def center_cloud(pc):
    """Subtract centroid; return (centered, offset=-centroid)."""
    pc = jnp.asarray(pc)
    centroid = jnp.mean(pc, axis=0)
    return pc - centroid, -centroid


def source_scaling_factor(pcs):
    """1 / max absolute coordinate of the (centered) source cloud."""
    return 1.0 / jnp.max(jnp.abs(pcs))


def cloud_ranges(pc):
    """Per-axis (min, max) of a cloud -> [3, 2]."""
    pc = jnp.asarray(pc)
    return jnp.stack([jnp.min(pc, axis=0), jnp.max(pc, axis=0)], axis=-1)


class Normalization:
    """Centering + source-max scaling applied to both clouds, and the
    inverse map for the final translation (fgoicp.hpp:87-90)."""

    def __init__(self, pct, pcs):
        pct = jnp.asarray(pct, jnp.float32)
        pcs = jnp.asarray(pcs, jnp.float32)
        pct_c, self.offset_pct = center_cloud(pct)
        pcs_c, self.offset_pcs = center_cloud(pcs)
        self.scale = source_scaling_factor(pcs_c)
        self.pct = pct_c * self.scale
        self.pcs = pcs_c * self.scale
        self.target_bounds = cloud_ranges(self.pct)

    def restore_translation(self, R, t):
        """t_world = t/scale + R @ offset_pcs - offset_pct."""
        return (t / self.scale
                + jnp.matmul(jnp.asarray(R), self.offset_pcs,
                             precision=jax.lax.Precision.HIGHEST)
                - self.offset_pct)
