"""On-device Procrustes alignment (Kabsch) with batched 3x3 SVD.

Replaces the reference's device->host->device round trip through Eigen's
JacobiSVD (/root/reference/fgoicp/icp3d.cu:110-138,140-172): here the
cross-covariance, SVD, and reflection fix all stay on the device inside
jit, and an arbitrary batch of alignments is solved at once.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _polar_orthogonal(m, iters: int = 9):
    """Orthogonal polar factor of [..., 3, 3] via determinant-scaled
    Newton iteration X <- (z X + (z X)^-T) / 2, z = |det X|^(-1/3).

    Quadratically convergent and more accurate in float32 than a general
    iterative SVD, with only 3x3 inverses and no host round trip.  The
    determinant scaling makes convergence near-immune to conditioning
    (plain Newton needs ~1 extra iteration per decade of singular-value
    spread — degenerate/collinear correspondences diverged in 9 rounds).
    """
    norm = jnp.linalg.norm(m, axis=(-2, -1), keepdims=True)
    x = m / jnp.maximum(norm, 1e-30)
    # Guard rank-deficient inputs (degenerate correspondences) with a
    # ridge so inv() stays finite; the result is still orthogonal.
    det = jnp.linalg.det(x)
    eye = jnp.eye(3, dtype=x.dtype)
    x = jnp.where((jnp.abs(det) < 1e-6)[..., None, None], x + 1e-3 * eye, x)
    for _ in range(iters):
        det = jnp.abs(jnp.linalg.det(x))
        z = jnp.clip(det, 1e-12, None) ** (-1.0 / 3.0)
        z = jnp.clip(z, 1e-3, 1e6)[..., None, None]
        zx = z * x
        xit = jnp.swapaxes(jnp.linalg.inv(zx), -1, -2)
        x = 0.5 * (zx + xit)
    return x


def _smallest_eigvec_sym3(a):
    """Unit eigenvector of the smallest eigenvalue of symmetric [..., 3, 3]."""
    w, v = jnp.linalg.eigh(a)  # ascending eigenvalues
    return v[..., :, 0]


def closest_rotation(abt):
    """Closest rotation (det=+1) to cross-covariance matrices [..., 3, 3].

    Given ABt = sum_i a_i b_i^T (a = centered source, b = centered
    correspondences), returns R minimizing sum ||R a_i - b_i||^2 — the
    Kabsch solution the reference computes with Eigen's JacobiSVD + a
    det(VU^T) reflection fix (icp3d.cu:110-138).  Here: R is the orthogonal
    polar factor of M = ABt^T (Newton iteration, fully on-device); when
    det(M) < 0 the proper-rotation fix R <- Q (I - 2 v3 v3^T) is applied,
    with v3 the smallest right-singular direction of M.
    """
    abt = jnp.asarray(abt, jnp.float32)
    m = jnp.swapaxes(abt, -1, -2)
    q = _polar_orthogonal(m)
    det_m = jnp.linalg.det(m)
    # Reflection fix (rare in ICP): smallest eigenvector of M^T M.
    hi = jax.lax.Precision.HIGHEST   # no TF32 rounding on the GPU
    v3 = _smallest_eigvec_sym3(
        jnp.matmul(jnp.swapaxes(m, -1, -2), m, precision=hi))
    refl = jnp.eye(3, dtype=m.dtype) - 2.0 * v3[..., :, None] * v3[..., None, :]
    q_fixed = jnp.matmul(q, refl, precision=hi)
    return jnp.where((det_m < 0)[..., None, None], q_fixed, q)


def procrustes(src, corr, mask=None):
    """Best rigid motion mapping src -> corr (both [..., N, 3]).

    Returns (R [..., 3, 3], t [..., 3]) with corr ~= R @ src + t.
    `mask` ([..., N]) optionally selects a subset (soft weights allowed);
    used for trimmed variants.  Parity with
    IterativeClosestPoint3D::procrustes (icp3d.cu:140-172).
    """
    src = jnp.asarray(src, jnp.float32)
    corr = jnp.asarray(corr, jnp.float32)
    if mask is None:
        w = jnp.ones(src.shape[:-1], src.dtype)
    else:
        w = jnp.asarray(mask, src.dtype)
    wsum = jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1e-12)
    mu_s = jnp.sum(src * w[..., None], axis=-2) / wsum
    mu_c = jnp.sum(corr * w[..., None], axis=-2) / wsum
    a = (src - mu_s[..., None, :]) * w[..., None]
    b = corr - mu_c[..., None, :]
    # ABt[r, c] = sum_i a_i[r] * b_i[c] -> R minimizes ||R a - b||;
    # reference accumulates outer(src_centered, corr_centered) then takes
    # closest orthogonal of that (icp3d.cu:162-169): same contraction.
    abt = jnp.einsum("...nr,...nc->...rc", a, b,
                     precision=jax.lax.Precision.HIGHEST)
    r = closest_rotation(abt)
    t = mu_c - jnp.einsum("...rc,...c->...r", r, mu_s,
                          precision=jax.lax.Precision.HIGHEST)
    return r, t
