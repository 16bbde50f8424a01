"""Fused lane bound kernel (Triton route, interpret mode on the CPU) vs
the XLA reference path, the kernel gate, and the XLA trimmed lane path."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fgoicp.ops import bounds as bounds_ops
from fgoicp.ops import geometry as geo
from fgoicp.ops import nn as nn_ops
from fgoicp.ops import pallas_bounds
from fgoicp.ops.pool_frontier import _eval_lanes_xla


def _case(seed=0, g=3, b=5, ns=700, p=300):
    rng = np.random.default_rng(seed)
    pcs = jnp.asarray(rng.uniform(-0.7, 0.7, size=(ns, 3)), jnp.float32)
    proxies = jnp.asarray(rng.uniform(-0.9, 0.9, size=(p, 3)), jnp.float32)
    xyz = jnp.asarray(rng.uniform(-0.4, 0.4, size=(g, 3)), jnp.float32)
    R = geo.quat_cube_to_matrix(xyz)
    rot_spans = jnp.asarray(rng.uniform(0.05, 0.4, size=(g,)), jnp.float32)
    fix = jnp.asarray([True, False, True][:g])
    tc = jnp.asarray(rng.uniform(-0.5, 0.5, size=(g, b, 3)), jnp.float32)
    ts = jnp.asarray(rng.uniform(0.05, 0.3, size=(g, b)), jnp.float32)
    return pcs, proxies, R, rot_spans, fix, tc, ts


def _backend(proxies, slack):
    return bounds_ops.ProxyBackend(
        coreset=bounds_ops.coreset_ops.ProxyCoreset(
            points=proxies, eps=jnp.float32(slack)))


def _xla_reference(pcs, proxies, R, rot_spans, fix, tc, ts, slack):
    return bounds_ops.evaluate_bounds(
        _backend(proxies, slack), pcs, R, rot_spans, fix, tc, ts)


def _interpret_lanes(monkeypatch):
    """Route the engine's kernel calls through interpret mode (the CPU
    has no GPU to compile them for) and record each call."""
    calls = []
    real = pallas_bounds.fused_bounds_lanes

    def spy(*args, **kw):
        calls.append(args[1].shape[0])
        return real(*args, **dict(kw, interpret=True))

    monkeypatch.setattr(pallas_bounds, "fused_bounds_lanes", spy)
    return calls


def test_fused_matches_xla_path(monkeypatch):
    """evaluate_bounds on the GPU path flattens its [G, B] grid into G * B
    lanes of the lane kernel; the result must match the XLA path."""
    pcs, proxies, R, rot_spans, fix, tc, ts = _case()
    slack = 0.03
    lb_ref, ub_ref = _xla_reference(pcs, proxies, R, rot_spans, fix, tc, ts,
                                    slack)
    calls = _interpret_lanes(monkeypatch)
    monkeypatch.setattr(bounds_ops, "_use_fused_kernel", lambda: True)
    lb, ub = bounds_ops.evaluate_bounds(_backend(proxies, slack), pcs, R,
                                        rot_spans, fix, tc, ts)
    assert calls == [3 * 5]
    assert lb.shape == ub.shape == (3, 5)
    np.testing.assert_allclose(np.asarray(ub), np.asarray(ub_ref),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(lb), np.asarray(lb_ref),
                               rtol=2e-4, atol=2e-5)


def test_fused_point_weights_mask_padding():
    pcs, proxies, R, rot_spans, fix, tc, ts = _case(seed=1, ns=600)
    # Zero-weight the last 100 points; reference drops them entirely.
    w = jnp.ones((600,), jnp.float32).at[500:].set(0.0)
    lb_ref, ub_ref = _xla_reference(pcs[:500], proxies, R, rot_spans, fix,
                                    tc, ts, 0.01)
    norms = jnp.linalg.norm(pcs, axis=-1)
    gam_r = jnp.where(
        fix[:, None], 0.0,
        geo.rotation_uncertainty_radius(norms[None, :], rot_spans[:, None]))
    gam_t = geo.translation_uncertainty_radius(ts)
    base = jnp.einsum("grc,nc->gnr", R, pcs,
                      precision=jax.lax.Precision.HIGHEST)
    g, b = ts.shape
    lb, ub = pallas_bounds.fused_bounds_lanes(
        base, jnp.repeat(jnp.arange(g, dtype=jnp.int32), b),
        tc.reshape(-1, 3), proxies, gam_r, gam_t.reshape(-1),
        jnp.float32(0.01), point_weights=w, interpret=True)
    np.testing.assert_allclose(np.asarray(ub).reshape(g, b),
                               np.asarray(ub_ref), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(lb).reshape(g, b),
                               np.asarray(lb_ref), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("ns,p", [
    (pallas_bounds.NT * 2 + 5, pallas_bounds.PT * 3 + 7),   # ragged tails
    (pallas_bounds.NT - 3, pallas_bounds.PT - 1),           # < one tile
    (pallas_bounds.NT * 2, pallas_bounds.PT),               # exact tiles
    (1, 1),
])
def test_lane_kernel_tails(ns, p):
    """Source and proxy counts that are not multiples of the tiles: the
    masked tails must contribute nothing (sources) and never win the
    min (proxies)."""
    rng = np.random.default_rng(ns * 1000 + p)
    g, L = 3, 9
    pcs = jnp.asarray(rng.uniform(-0.7, 0.7, size=(ns, 3)), jnp.float32)
    proxies = jnp.asarray(rng.uniform(-0.9, 0.9, size=(p, 3)), jnp.float32)
    R = geo.quat_cube_to_matrix(jnp.asarray(
        rng.uniform(-0.4, 0.4, size=(g, 3)), jnp.float32))
    base = jnp.einsum("grc,nc->gnr", R, pcs,
                      precision=jax.lax.Precision.HIGHEST)
    gam_ub, gam_lb = bounds_ops.gamma_arrays(
        jnp.linalg.norm(pcs, axis=-1), jnp.full((g,), 0.2),
        jnp.asarray([True, False, False]))
    gids = jnp.asarray(rng.integers(0, g, size=(L,)), jnp.int32)
    t_lanes = jnp.asarray(rng.uniform(-0.4, 0.4, size=(L, 3)), jnp.float32)
    gam_t = jnp.asarray(rng.uniform(0.0, 0.2, size=(L,)), jnp.float32)
    slack = jnp.float32(0.02)
    lb, ub = pallas_bounds.fused_bounds_lanes(
        base, gids, t_lanes, proxies, gam_ub, gam_t, slack, gam_lb=gam_lb,
        interpret=True)
    lb_x, ub_x = _eval_lanes_xla(_backend(proxies, slack), base, gids,
                                 t_lanes, gam_ub, gam_lb, gam_t, None, None)
    np.testing.assert_allclose(np.asarray(ub), np.asarray(ub_x),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(lb), np.asarray(lb_x),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("platform,want", [("gpu", True), ("cpu", False)])
def test_kernel_choice_by_backend(monkeypatch, platform, want):
    """The kernels run where JAX's default backend is the GPU; the CPU
    takes the XLA path."""
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert nn_ops.use_pallas() is want
    assert bounds_ops._use_fused_kernel() is want


@pytest.mark.parametrize("trim_keep,kernel_calls", [(None, 1), (40, 0)])
def test_pooled_frontier_kernel_choice(monkeypatch, trim_keep,
                                       kernel_calls):
    """On the GPU the pooled frontier evaluates untrimmed proxy lanes in
    the fused kernel and trimmed lanes on the XLA path (the kernel has no
    drop-sum stage); both reach the same search result as the CPU path."""
    from fgoicp.ops import pool_frontier
    pcs, proxies, R, rot_spans, fix, _, _ = _case(seed=4, ns=50, p=40)
    backend = _backend(proxies, 0.01)
    args = (backend, pcs, R, rot_spans, fix, jnp.float32(1e9),
            jnp.float32(1e-2))
    kw = dict(lanes=8, capacity=256, max_steps=6, min_span=0.25,
              trim_keep=trim_keep)
    want = pool_frontier.bnb_r3_pooled(*args, **kw)
    calls = _interpret_lanes(monkeypatch)
    monkeypatch.setattr(bounds_ops, "_use_fused_kernel", lambda: True)
    jax.clear_caches()
    got = pool_frontier.bnb_r3_pooled(*args, **kw)
    jax.clear_caches()
    assert len(calls) == kernel_calls
    np.testing.assert_allclose(np.asarray(got.best_ub),
                               np.asarray(want.best_ub), rtol=2e-4,
                               atol=2e-5)
    assert int(got.steps) == int(want.steps)


def test_xla_trimmed_lanes_match_brute_trimmed_sum():
    """The XLA trimmed lane path (threshold-bisection drop-sum bracket)
    against a brute trimmed sum over exact per-point distances: total
    minus the n_drop largest terms."""
    rng = np.random.default_rng(7)
    g, L, ns, p = 4, 16, 300, 120
    pcs = rng.uniform(-0.7, 0.7, size=(ns, 3)).astype(np.float32)
    proxies = rng.uniform(-0.9, 0.9, size=(p, 3)).astype(np.float32)
    R = geo.quat_cube_to_matrix(jnp.asarray(
        rng.uniform(-0.4, 0.4, size=(g, 3)), jnp.float32))
    rot_spans = jnp.asarray(rng.uniform(0.05, 0.4, size=(g,)), jnp.float32)
    fix = jnp.asarray([True, False, True, False])
    slack = 0.03
    base = jnp.einsum("grc,nc->gnr", R, jnp.asarray(pcs),
                      precision=jax.lax.Precision.HIGHEST)
    gam_ub, gam_lb = bounds_ops.gamma_arrays(
        jnp.linalg.norm(jnp.asarray(pcs), axis=-1), rot_spans, fix)
    gids = rng.integers(0, g, size=(L,)).astype(np.int32)
    t_lanes = rng.uniform(-0.4, 0.4, size=(L, 3)).astype(np.float32)
    gam_t = np.asarray(geo.translation_uncertainty_radius(jnp.asarray(
        rng.uniform(0.05, 0.3, size=(L,)), jnp.float32)))

    q = np.asarray(base, np.float64)[gids] + t_lanes[:, None, :]
    d = np.sqrt(((q[:, :, None, :] - proxies[None, None]) ** 2)
                .sum(-1).min(-1))                            # [L, ns]
    ub_t = np.maximum(d - np.asarray(gam_ub)[gids], 0.0) ** 2
    lb_t = np.maximum(d - slack - np.asarray(gam_lb)[gids]
                      - gam_t[:, None], 0.0) ** 2
    for trim_keep in (ns - 1, int(0.7 * ns), ns // 3):
        n_drop = ns - trim_keep
        want_ub = ub_t.sum(-1) - np.sort(ub_t, -1)[:, ns - n_drop:].sum(-1)
        want_lb = lb_t.sum(-1) - np.sort(lb_t, -1)[:, ns - n_drop:].sum(-1)
        lb, ub = _eval_lanes_xla(
            _backend(jnp.asarray(proxies), slack), base, jnp.asarray(gids),
            jnp.asarray(t_lanes), gam_ub, gam_lb, jnp.asarray(gam_t), None,
            trim_keep)
        np.testing.assert_allclose(np.asarray(ub), want_ub, rtol=2e-4,
                                   atol=2e-5)
        np.testing.assert_allclose(np.asarray(lb), want_lb, rtol=2e-4,
                                   atol=2e-5)
        assert bool(jnp.all(lb <= ub + 1e-5))
