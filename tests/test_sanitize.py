"""Search-state sanitizer (utils/sanitize.py, SURVEY §5 sanitizer row):
clean runs pass with checks on; corrupted state is caught by name."""
import numpy as np
import pytest

from util import std_engine
from test_checkpoint import _pair
from fgoicp.models.goicp import GoICP
from fgoicp.ops import so3_frontier as so3
from fgoicp.utils import sanitize


def test_clean_host_run_passes_with_checks_on():
    pct, pcs = _pair()
    m = GoICP(pct, pcs, mse_threshold=5e-4,
              engine=std_engine(debug_checks=True))
    m.run()
    assert m.mse < 5e-4


def test_clean_device_run_passes_with_checks_on():
    pct, pcs = _pair()
    m = GoICP(pct, pcs, mse_threshold=5e-4,
              engine=std_engine(debug_checks=True, outer_mode="device",
                                so3_capacity=2048))
    m.run()
    assert m.mse < 5e-4


def test_check_heap_catches_corruption():
    good = (0.5, 0, (0.1, 0.2, 0.3, 0.25, 1.5))
    sanitize.check_heap([good])
    with pytest.raises(sanitize.SanitizeError, match="lb .* > ub"):
        sanitize.check_heap([(0.5, 0, (0.1, 0.2, 0.3, 0.25, 0.4))])
    with pytest.raises(sanitize.SanitizeError, match="span"):
        sanitize.check_heap([(0.5, 0, (0.1, 0.2, 0.3, 0.0, 1.5))])
    with pytest.raises(sanitize.SanitizeError, match="finite"):
        sanitize.check_heap([(-1.0, 0, (0.1, 0.2, 0.3, 0.25, 1.5))])
    with pytest.raises(sanitize.SanitizeError, match="root quaternion"):
        sanitize.check_heap([(0.5, 0, (2.0, 0.0, 0.0, 0.25, 1.5))])


def test_check_device_state_catches_corruption():
    st = so3.initial_state(8, history_capacity=4)
    sanitize.check_device_state(st)
    with pytest.raises(sanitize.SanitizeError, match="sorted"):
        bad = np.asarray(st.lbs).copy()
        bad[0], bad[3] = 5.0, 0.0
        sanitize.check_device_state(st._replace(lbs=bad))
    with pytest.raises(sanitize.SanitizeError, match="lb > ub"):
        bad_ub = np.asarray(st.ubs).copy()
        bad_ub[0] = -1.0
        sanitize.check_device_state(st._replace(ubs=bad_ub))
    with pytest.raises(sanitize.SanitizeError, match="span"):
        bad_sp = np.asarray(st.spans).copy()
        bad_sp[0] = 0.0
        sanitize.check_device_state(st._replace(spans=bad_sp))
    with pytest.raises(sanitize.SanitizeError, match="hist_len"):
        sanitize.check_device_state(st._replace(hist_len=np.int32(9)))
    with pytest.raises(sanitize.SanitizeError, match="non-increasing"):
        hs = np.asarray(st.hist_sse).copy()
        hs[0], hs[1] = 1.0, 2.0
        sanitize.check_device_state(
            st._replace(hist_sse=hs, hist_len=np.int32(2),
                        best_sse=np.float32(2.0)))
    with pytest.raises(sanitize.SanitizeError, match="counter"):
        sanitize.check_device_state(st._replace(pruned=np.int32(-1)))


def test_check_incumbent_catches_mismatch():
    pct, pcs = _pair()
    m = GoICP(pct, pcs, mse_threshold=5e-4, engine=std_engine())
    # No incumbent yet: the check is a no-op.
    sanitize.check_incumbent(m)
    # A fabricated incumbent whose sse does not match its (R, t).
    m.best_rotation = np.eye(3, dtype=np.float32)
    m.best_translation = np.zeros(3, np.float32)
    m.best_sse = 123.456
    with pytest.raises(sanitize.SanitizeError, match="exact SSE"):
        sanitize.check_incumbent(m)
