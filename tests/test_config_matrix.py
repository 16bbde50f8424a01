"""Engine configuration matrix: every scheduling / backend / feature
combination must certify the SAME global optimum on one shared problem.

Individual combinations are covered by their own test files; this
matrix exists for the interactions (device x lut x trim, grouped x
trim, pooled x clusters x coreset, ...) where a regression would
otherwise surface only as a silently different pose on some config a
user picked.  Opt-in (FGOICP_SLOW=1): the combos deliberately span
distinct compiled programs, so the sweep costs minutes of CPU compile.
"""

import os

import numpy as np
import pytest

from util import std_engine

pytestmark = [
    pytest.mark.slow,
    pytest.mark.skipif(
        os.environ.get("FGOICP_SLOW") != "1",
        reason="opt-in: full config-matrix sweep (set FGOICP_SLOW=1)"),
]


def _problem():
    rng = np.random.default_rng(21)
    s = rng.uniform(0.0, 4.5, size=(150,))
    pct = np.stack([np.cos(s), 0.7 * np.sin(2 * s),
                    0.4 * np.sin(3 * s + 0.5)], axis=1)
    pct = (pct + rng.normal(scale=0.01, size=pct.shape)).astype(np.float32)
    ang = 2.0
    c, s0 = np.cos(ang), np.sin(ang)
    R_true = np.array([[c, -s0, 0], [s0, c, 0], [0, 0, 1]], np.float32)
    t_true = np.array([0.2, -0.1, 0.15], np.float32)
    pcs = (pct[:100] - t_true) @ R_true
    return pct, pcs, R_true, t_true


# (label, outer_mode, frontier_mode, backend, source_coreset, trim
#  [, pool_update])
COMBOS = [
    ("host-pooled-proxy", "host", "pooled", "proxy", 0, 0.0),
    ("host-pooled-proxy-merge", "host", "pooled", "proxy", 0, 0.0,
     "merge"),
    ("device-proxy-merge", "device", "pooled", "proxy", 0, 0.0, "merge"),
    ("host-pooled-exact-trim-merge", "host", "pooled", "exact", 0, 0.2,
     "merge"),
    ("host-pooled-exact", "host", "pooled", "exact", 0, 0.0),
    ("host-pooled-lut", "host", "pooled", "lut", 0, 0.0),
    ("host-grouped-exact", "host", "grouped", "exact", 0, 0.0),
    ("host-grouped-exact-trim", "host", "grouped", "exact", 0, 0.2),
    ("host-pooled-exact-coreset", "host", "pooled", "exact", 32, 0.0),
    ("host-pooled-exact-trim", "host", "pooled", "exact", 0, 0.2),
    ("host-pooled-exact-coreset-trim", "host", "pooled", "exact", 32, 0.2),
    ("host-pooled-lut-trim", "host", "pooled", "lut", 0, 0.2),
    ("device-proxy", "device", "pooled", "proxy", 0, 0.0),
    ("device-exact", "device", "pooled", "exact", 0, 0.0),
    ("device-lut", "device", "pooled", "lut", 0, 0.0),
    ("device-exact-coreset", "device", "pooled", "exact", 32, 0.0),
    ("device-exact-trim", "device", "pooled", "exact", 0, 0.2),
    ("device-exact-coreset-trim", "device", "pooled", "exact", 32, 0.2),
]


@pytest.mark.parametrize(
    "combo", COMBOS, ids=[c[0] for c in COMBOS])
def test_matrix_same_certified_optimum(combo):
    from fgoicp.models.goicp import GoICP

    label, outer, frontier, backend, coreset, trim = combo[:6]
    pool_update = combo[6] if len(combo) > 6 else "sort"
    pct, pcs, R_true, t_true = _problem()
    eng = std_engine(outer_mode=outer, frontier_mode=frontier,
                     source_coreset=coreset, so3_capacity=2048,
                     pool_update=pool_update)
    m = GoICP(pct, pcs, engine=eng, mse_threshold=5e-4,
              bound_backend=backend, proxy_size=64, lut_resolution=0.05,
              trim_fraction=trim)
    R, t = m.run()
    # The source is an exact subset of the target, so the global
    # optimum recovers the known transform REGARDLESS of trimming
    # (dropping residuals of a perfect alignment keeps it optimal).
    np.testing.assert_allclose(np.asarray(R), R_true, atol=2e-3,
                               err_msg=label)
    np.testing.assert_allclose(np.asarray(t), t_true, atol=2e-3,
                               err_msg=label)
    # And the run certifies: the engine's own termination gap closed —
    # last_certified_gap is mode-agnostic (the host heap is cleared in
    # device mode, so a heap_min_lb check would be vacuous there).
    assert m.last_certified_gap is not None, label
    assert m.last_certified_gap <= m.sse_threshold * 1.0001, label
