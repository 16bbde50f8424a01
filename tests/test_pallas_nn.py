"""NN kernels (Triton route, interpret mode on the CPU) vs the XLA path."""
import jax.numpy as jnp
import numpy as np
import pytest

from fgoicp.ops import nn as nn_ops
from fgoicp.ops import pallas_nn


def test_nn_argmin_matches_xla():
    rng = np.random.default_rng(0)
    queries = jnp.asarray(rng.uniform(-1, 1, size=(733, 3)), jnp.float32)
    points = jnp.asarray(rng.uniform(-1, 1, size=(517, 3)), jnp.float32)
    d2_k, idx_k = pallas_nn.nn_argmin(queries, points, interpret=True)
    d2_ref, idx_ref = nn_ops.nearest_neighbor(
        queries, points)  # XLA path (use_pallas() is False on CPU)
    np.testing.assert_array_equal(np.asarray(idx_k), np.asarray(idx_ref))
    np.testing.assert_allclose(np.asarray(d2_k), np.asarray(d2_ref),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(
        np.asarray(pallas_nn.nn_min(queries, points, interpret=True)),
        np.asarray(d2_ref), rtol=1e-6, atol=1e-9)


def test_nn_argmin_exact_on_grid():
    # Queries exactly on target points: d2 == 0, idx == identity.
    pts = jnp.asarray(np.mgrid[0:4, 0:4, 0:4].reshape(3, -1).T, jnp.float32)
    d2, idx = pallas_nn.nn_argmin(pts, pts, interpret=True)
    np.testing.assert_array_equal(np.asarray(idx), np.arange(len(pts)))
    np.testing.assert_allclose(np.asarray(d2), 0.0, atol=1e-5)


@pytest.mark.parametrize("m,n", [
    (pallas_nn.QT * 2 + 3, pallas_nn.TT * 5 + 11),    # ragged tails
    (5, 7),                                           # below one tile
    (40, 16 * pallas_nn.TT * 3 + 1),                  # several target splits
])
def test_ties_go_to_lowest_index(m, n):
    """Every target point appears twice: the winner must be the first
    copy, as jnp.argmin picks, across tiles and target splits."""
    rng = np.random.default_rng(m + n)
    half = jnp.asarray(rng.uniform(-1, 1, size=(n, 3)), jnp.float32)
    points = jnp.concatenate([half, half])
    queries = jnp.asarray(rng.uniform(-1, 1, size=(m, 3)), jnp.float32)
    d2, idx = pallas_nn.nn_argmin(queries, points, interpret=True)
    d2_ref, idx_ref = nn_ops.xla_nearest(queries, points, want_idx=True)
    assert int(jnp.max(idx)) < n
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(idx_ref))
    np.testing.assert_allclose(np.asarray(d2), np.asarray(d2_ref),
                               rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("m,n,want", [
    (16 * 2048, 17953, 2),      # ICP NN: 512 query blocks, 2 splits
    (10000, 98359, 7),          # full-resolution target: 157 blocks
    (100, 50, 1),               # tiny target: never split
])
def test_target_splits_fill_the_card(m, n, want):
    """Short query axes split the target across programs, and no split
    is shorter than 8 tiles."""
    qt, tt = 64, 64
    s = pallas_nn._target_splits(m, n, qt, tt)
    assert s == want
    assert s == 1 or n / s >= 8 * tt
