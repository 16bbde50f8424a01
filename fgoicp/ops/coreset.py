"""Proxy coreset for bound evaluation: farthest-point sampling + covering
radius.

An alternative to the reference's dense distance-field LUT
(/root/reference/fgoicp/registration.cu:180-328): instead of random
gathers from a multi-GB voxel grid, BnB bounds query the exact nearest
neighbor against a small proxy subset of the target by a dense
squared-difference min-reduction (no build cost, no device-memory
blow-up).

Validity: for proxy set S subset of target T with covering radius
eps = max_{t in T} dist(t, S):
    d_S(q) - eps <= d_T(q) <= d_S(q)        for every query q.
So upper bounds use d_S directly and lower bounds subtract eps — both
strictly valid, unlike the reference LUT whose interpolation error is
unaccounted for.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import nn as nn_ops


class ProxyCoreset(NamedTuple):
    points: jnp.ndarray   # [P, 3] proxy subset of the target
    eps: jnp.ndarray      # scalar covering radius (world units)


class SourceClusters(NamedTuple):
    """Weighted clustering of the SOURCE cloud for hierarchical bounds.

    Each original source point is assigned to its nearest representative;
    a cluster of m_k points with radius delta_k contributes
        ub_k = m_k * relu(d(R q_k + t) + delta_k - gamma_min)^2
        lb_k = m_k * relu(d(R q_k + t) - delta_k - gamma_max - ...)^2
    — valid two-sided bounds on the cluster's true SSE contribution
    (1-Lipschitz distance field + monotone rotation radius).  Shrinks the
    per-node bound cost from O(ns * P) to O(K * P).
    """

    reps: jnp.ndarray     # [K, 3] representatives
    weights: jnp.ndarray  # [K] member counts (float)
    deltas: jnp.ndarray   # [K] cluster radii


@functools.partial(jax.jit, static_argnames=("k",))
def farthest_point_sample(points, k: int, seed: int = 0):
    """Greedy farthest-point subsample: k indices maximizing min spacing.

    O(k * n) — one distance update per selected point.
    """
    points = jnp.asarray(points, jnp.float32)
    n = points.shape[0]

    def body(i, carry):
        mind2, idx = carry
        far = jnp.argmax(mind2)
        idx = idx.at[i].set(far)
        d2 = jnp.sum((points - points[far]) ** 2, axis=-1)
        return jnp.minimum(mind2, d2), idx

    init_mind2 = jnp.sum((points - points[seed % n]) ** 2, axis=-1)
    idx0 = jnp.zeros((k,), jnp.int32).at[0].set(seed % n)
    mind2, idx = jax.lax.fori_loop(1, k, body, (init_mind2, idx0))
    return idx


def build_weighted(points, size: int = 1024, seed: int = 0) -> SourceClusters:
    """Cluster a source cloud: FPS representatives + nearest assignment."""
    points = jnp.asarray(points, jnp.float32)
    n = points.shape[0]
    if n <= size:
        return SourceClusters(points, jnp.ones((n,), jnp.float32),
                              jnp.zeros((n,), jnp.float32))
    idx = farthest_point_sample(points, size, seed)
    reps = points[idx]
    d2, assign = nn_ops.nearest_neighbor(points, reps)
    d = jnp.sqrt(jnp.maximum(d2, 0.0))
    weights = jnp.zeros((size,), jnp.float32).at[assign].add(1.0)
    deltas = jnp.zeros((size,), jnp.float32).at[assign].max(d)
    return SourceClusters(reps, weights, deltas)


def build(target, size: int = 4096, seed: int = 0) -> ProxyCoreset:
    """Build the proxy coreset.  If the target is small enough, use it all
    (eps = 0: bounds become exact-NN — tighter than any LUT)."""
    target = jnp.asarray(target, jnp.float32)
    nt = target.shape[0]
    if nt <= size:
        return ProxyCoreset(points=target, eps=jnp.float32(0.0))
    idx = farthest_point_sample(target, size, seed)
    proxies = target[idx]
    # Exact covering radius: max over target of distance to proxy set.
    d2 = nn_ops.nearest_sqdist(target, proxies)
    eps = jnp.sqrt(jnp.maximum(jnp.max(d2), 0.0))
    return ProxyCoreset(points=proxies, eps=eps)
