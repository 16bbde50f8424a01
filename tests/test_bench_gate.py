"""The kernel gate must be BINDING on the bench harness.

A gate that only logged its failure to stderr would let a green bench
artifact ship beside a red kernel check.  These tests force the gate red
and assert bench.main() (a) stamps gate_failed into every emitted JSON
line and (b) exits nonzero; that a green gate does neither; and that the
gate refuses to run without a GPU.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import sys

import pytest


def _load_bench():
    spec = importlib.util.spec_from_file_location(
        "bench_under_test", "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture()
def bench(monkeypatch):
    mod = _load_bench()
    # Replace every workload with a stub that emits one line, so the
    # test exercises the gate plumbing without running registrations.
    def fake_workload(lines):
        lines.append({"metric": "stub", "value": 1.0, "unit": "s",
                      "vs_baseline": 1.0, "converged": True})
    for name in ("bench_skull", "bench_dragon", "bench_serving",
                 "bench_bunny"):
        monkeypatch.setattr(mod, name, fake_workload)
    monkeypatch.setattr(sys, "argv", ["bench.py"])
    return mod


def test_red_gate_fails_bench(bench, monkeypatch):
    monkeypatch.setattr(bench, "_kernel_gate", lambda: False)
    buf = io.StringIO()
    with pytest.raises(SystemExit) as exc, \
            contextlib.redirect_stdout(buf):
        bench.main()
    assert exc.value.code == 1
    out = [json.loads(ln) for ln in buf.getvalue().strip().splitlines()]
    assert out, "bench printed no JSON lines"
    assert all(line.get("gate_failed") is True for line in out)


def test_green_gate_passes_bench(bench, monkeypatch):
    monkeypatch.setattr(bench, "_kernel_gate", lambda: True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench.main()  # must NOT raise SystemExit
    out = [json.loads(ln) for ln in buf.getvalue().strip().splitlines()]
    assert out
    assert all("gate_failed" not in line for line in out)


class _FakeGpu:
    platform = "gpu"
    device_kind = "test stand-in"


def test_crashed_gate_is_red(bench, monkeypatch, tmp_path):
    """A gate that CRASHES (e.g. a kernel that fails to compile) must
    report red, not green, and say so in its record."""
    class _Boom:
        @staticmethod
        def run_check():
            raise RuntimeError("forced kernel compile failure")

    import jax
    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeGpu()])
    monkeypatch.setitem(sys.modules, "kernel_check", _Boom)
    record = tmp_path / "out" / "KERNELCHECK.json"
    monkeypatch.setattr(bench, "GATE_RECORD", str(record))
    assert bench._kernel_gate() is False
    rec = json.loads(record.read_text())
    assert rec["ok"] is False
    assert rec["platform"] == "gpu"


def test_gate_without_gpu_stops_the_bench(bench, monkeypatch, tmp_path):
    """Without a GPU the gate exits before any measurement and writes no
    record: a CPU number is not a bench result."""
    record = tmp_path / "KERNELCHECK.json"
    monkeypatch.setattr(bench, "GATE_RECORD", str(record))
    with pytest.raises(SystemExit, match="needs a GPU"):
        bench._kernel_gate()
    assert not record.exists()
