"""The Pallas kernels as compiled for the GPU, against the XLA path.

These run only on a machine with a GPU (`python -m pytest tests -m gpu`);
everywhere else the `gpu` fixture skips them.  The interpret-mode tests
in test_pallas_bounds.py / test_pallas_nn.py cover the same arithmetic on
the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fgoicp.ops import bounds as bounds_ops
from fgoicp.ops import geometry as geo
from fgoicp.ops import nn as nn_ops
from fgoicp.ops import pallas_bounds, pallas_nn

pytestmark = pytest.mark.gpu


def test_lane_kernel_matches_xla(gpu):
    rng = np.random.default_rng(0)
    g, L, ns, p = 6, 256, 3037, 1024
    pcs = jnp.asarray(rng.uniform(-0.7, 0.7, size=(ns, 3)), jnp.float32)
    proxies = jnp.asarray(rng.uniform(-0.9, 0.9, size=(p, 3)), jnp.float32)
    R = geo.quat_cube_to_matrix(jnp.asarray(
        rng.uniform(-0.4, 0.4, size=(g, 3)), jnp.float32))
    base = jnp.einsum("grc,nc->gnr", R, pcs,
                      precision=jax.lax.Precision.HIGHEST)
    gam_ub, gam_lb = bounds_ops.gamma_arrays(
        jnp.linalg.norm(pcs, axis=-1), jnp.full((g,), 0.1),
        jnp.arange(g) % 2 == 0)
    gids = jnp.asarray(rng.integers(0, g, size=(L,)), jnp.int32)
    t_lanes = jnp.asarray(rng.uniform(-0.4, 0.4, size=(L, 3)), jnp.float32)
    gam_t = jnp.asarray(rng.uniform(0.0, 0.2, size=(L,)), jnp.float32)
    lb, ub = pallas_bounds.fused_bounds_lanes(
        base, gids, t_lanes, proxies, gam_ub, gam_t, jnp.float32(0.01),
        gam_lb=gam_lb)
    q = base[gids] + t_lanes[:, None, :]
    d = jnp.sqrt(nn_ops.xla_nearest(q.reshape(-1, 3), proxies)).reshape(
        L, ns)
    ub_x = jnp.sum(jnp.maximum(d - gam_ub[gids], 0.0) ** 2, -1)
    lb_x = jnp.sum(jnp.maximum(d - 0.01 - gam_lb[gids] - gam_t[:, None],
                               0.0) ** 2, -1)
    np.testing.assert_allclose(np.asarray(ub), np.asarray(ub_x),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(lb), np.asarray(lb_x),
                               rtol=2e-4, atol=2e-5)


def test_nn_kernels_match_xla(gpu):
    rng = np.random.default_rng(1)
    q = jnp.asarray(rng.uniform(-1, 1, size=(5000, 3)), jnp.float32)
    pts = jnp.asarray(rng.uniform(-1, 1, size=(20011, 3)), jnp.float32)
    d2, idx = pallas_nn.nn_argmin(q, pts)
    d2_x, idx_x = nn_ops.xla_nearest(q, pts, want_idx=True)
    np.testing.assert_allclose(np.asarray(d2), np.asarray(d2_x),
                               rtol=1e-6, atol=0.0)
    np.testing.assert_allclose(np.asarray(pallas_nn.nn_min(q, pts)),
                               np.asarray(d2_x), rtol=1e-6, atol=0.0)
    tie = np.asarray(idx) != np.asarray(idx_x)
    d_win = np.asarray(jnp.sum((q - pts[idx]) ** 2, -1))
    np.testing.assert_allclose(d_win[tie], np.asarray(d2_x)[tie],
                               rtol=1e-6, atol=0.0)
