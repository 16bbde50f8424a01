"""Tests for exact NN search and SSE (ops/nn.py)."""

import jax.numpy as jnp
import numpy as np

from fgoicp.ops import nn as nn_ops


def _brute(queries, target):
    d2 = np.sum((queries[:, None, :] - target[None, :, :]) ** 2, axis=-1)
    return d2.min(axis=1), d2.argmin(axis=1)


class TestNearest:
    def test_matches_bruteforce_small(self):
        rng = np.random.default_rng(0)
        q = rng.normal(size=(37, 3)).astype(np.float32)
        t = rng.normal(size=(53, 3)).astype(np.float32)
        d2, idx = nn_ops.nearest_neighbor(jnp.asarray(q), jnp.asarray(t))
        ed2, eidx = _brute(q, t)
        np.testing.assert_allclose(np.asarray(d2), ed2, rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(np.asarray(idx), eidx)

    def test_matches_bruteforce_chunked(self):
        # Force both query- and target-chunking paths.
        rng = np.random.default_rng(1)
        q = rng.normal(size=(300, 3)).astype(np.float32)
        t = rng.normal(size=(500, 3)).astype(np.float32)
        d2, idx = nn_ops.nearest_neighbor(
            jnp.asarray(q), jnp.asarray(t), t_chunk=128, q_chunk=128)
        ed2, eidx = _brute(q, t)
        np.testing.assert_allclose(np.asarray(d2), ed2, rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(np.asarray(idx), eidx)

    def test_sqdist_only(self):
        rng = np.random.default_rng(2)
        q = rng.normal(size=(64, 3)).astype(np.float32)
        t = rng.normal(size=(64, 3)).astype(np.float32)
        d2 = nn_ops.nearest_sqdist(jnp.asarray(q), jnp.asarray(t), t_chunk=32)
        ed2, _ = _brute(q, t)
        np.testing.assert_allclose(np.asarray(d2), ed2, rtol=1e-4, atol=1e-5)

    def test_zero_distance_for_identical(self):
        rng = np.random.default_rng(3)
        t = rng.normal(size=(40, 3)).astype(np.float32)
        d2 = nn_ops.nearest_sqdist(jnp.asarray(t), jnp.asarray(t))
        np.testing.assert_allclose(np.asarray(d2), 0.0, atol=1e-5)


class TestExactSSE:
    def test_identity_on_same_cloud(self):
        rng = np.random.default_rng(4)
        pc = rng.normal(size=(50, 3)).astype(np.float32)
        sse = nn_ops.exact_sse(jnp.asarray(pc), jnp.asarray(pc),
                               jnp.eye(3), jnp.zeros(3))
        assert float(sse) < 1e-8

    def test_known_translation(self):
        # Single far-apart points: SSE = residual after wrong transform.
        pct = np.array([[0.0, 0.0, 0.0], [10, 10, 10]], np.float32)
        pcs = np.array([[1.0, 0.0, 0.0]], np.float32)
        sse = nn_ops.exact_sse(jnp.asarray(pct), jnp.asarray(pcs),
                               jnp.eye(3), jnp.zeros(3))
        np.testing.assert_allclose(float(sse), 1.0, rtol=1e-5)

    def test_trimmed_sse_drops_outliers(self):
        pct = np.zeros((1, 3), np.float32)
        pcs = np.array([[0, 0, 0], [0, 0, 0], [0, 0, 0], [100, 0, 0]], np.float32)
        full = nn_ops.exact_sse(jnp.asarray(pct), jnp.asarray(pcs),
                                jnp.eye(3), jnp.zeros(3))
        trimmed = nn_ops.exact_sse(jnp.asarray(pct), jnp.asarray(pcs),
                                   jnp.eye(3), jnp.zeros(3), trim_fraction=0.25)
        np.testing.assert_allclose(float(full), 10000.0, rtol=1e-5)
        np.testing.assert_allclose(float(trimmed), 0.0, atol=1e-6)
