"""Seeded synthetic clouds with known poses (smoke runs, kernel checks).

The surface is a closed, star-shaped bumpy blob: r(v) over unit
directions v, with bumps along every axis and an anisotropic scale, so
it has no rotational symmetry and a registration against it has one
true pose.
"""

from __future__ import annotations

import numpy as np


def bumpy_surface(n: int, seed: int = 0) -> np.ndarray:
    """n points [n, 3] float32 on the surface, drawn from `seed`."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    x, y, z = v[:, 0], v[:, 1], v[:, 2]
    r = (1.0 + 0.25 * np.sin(3.0 * x + 0.5)
         + 0.2 * np.sin(2.0 * y + 1.3) * np.cos(3.0 * z)
         + 0.15 * np.sin(5.0 * z + 2.0 * x))
    return (v * r[:, None] * np.array([1.0, 0.8, 0.7])).astype(np.float32)


def random_rotation(rng: np.random.Generator, angle=None) -> np.ndarray:
    """Proper rotation [3, 3]: uniform over SO(3) (QR of a Gaussian
    matrix), or `angle` radians about a uniformly random axis."""
    if angle is not None:
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        k = np.array([[0.0, -axis[2], axis[1]], [axis[2], 0.0, -axis[0]],
                      [-axis[1], axis[0], 0.0]])
        return (np.eye(3) + np.sin(angle) * k
                + (1.0 - np.cos(angle)) * k @ k).astype(np.float32)
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))[None, :]
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q.astype(np.float32)


def posed(points, R, t) -> np.ndarray:
    """Source cloud that (R, t) maps back onto `points`: R s + t = p."""
    p = np.asarray(points, np.float32)
    return ((p - np.asarray(t, np.float32)) @ np.asarray(R, np.float32)
            ).astype(np.float32)


def known_pose_pair(cloud, n_target: int, n_source: int, seed: int = 0,
                    angle=None):
    """(target, source, R, t): independent random subsets of `cloud`,
    the source moved by a random pose (rotation `angle` radians about a
    random axis, or uniform over SO(3)) that (R, t) undoes."""
    rng = np.random.default_rng(seed)
    cloud = np.asarray(cloud, np.float32)
    ti = rng.choice(len(cloud), size=n_target, replace=False)
    si = rng.choice(len(cloud), size=n_source, replace=False)
    R = random_rotation(rng, angle)
    span = float(np.ptp(cloud, axis=0).max())
    t = (rng.uniform(-0.15, 0.15, size=3) * span).astype(np.float32)
    return cloud[ti], posed(cloud[si], R, t), R, t
