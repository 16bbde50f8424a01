"""REAL jax.distributed multi-host test: 2 OS processes on localhost.

Every other distributed test runs the ThreadCommunicator double; the
a deadlock bug once lived precisely in the gap between the double and
the real wire.  This test spawns two actual
processes, brings up `jax.distributed.initialize` on the CPU backend,
and drives MultiHostGoICP end-to-end through
JaxProcessCommunicator.allgather — including the f32 (hi, lo) wire
through a real multihost_utils.process_allgather.

The worker lives in this file's __main__ guard; pytest only runs the
parent, which execs `python thisfile.py <rank> <coord>` twice with a
sanitized CPU environment.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_CURVE_N = 120


def _problem():
    rng = np.random.default_rng(17)
    s = rng.uniform(0.0, 4.5, size=(_CURVE_N,))
    pct = np.stack([np.cos(s), 0.7 * np.sin(2 * s),
                    0.4 * np.sin(3 * s + 0.5)], axis=1)
    pct = (pct + rng.normal(scale=0.01, size=(_CURVE_N, 3))).astype(
        np.float32)
    ang = 2.0
    c, s0 = np.cos(ang), np.sin(ang)
    R_true = np.array([[c, -s0, 0], [s0, c, 0], [0, 0, 1]], np.float32)
    t_true = np.array([0.2, -0.1, 0.15], np.float32)
    pcs = (pct[:80] - t_true) @ R_true
    return pct, pcs, R_true, t_true


def _worker(rank: int, coordinator: str, mode: str = "host") -> None:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    # jax.distributed.initialize must run before ANYTHING touches the XLA
    # backend — importing fgoicp builds module-level jnp constants, so
    # the runtime comes up first, bare.
    import jax
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=2, process_id=rank)
    from util import std_engine
    from fgoicp.parallel import distributed as dist
    from fgoicp.parallel.chaos import ChaosCommunicator

    comm = dist.JaxProcessCommunicator()
    assert comm.size == 2 and comm.rank == rank
    chaos = mode.startswith("chaos-")
    if chaos:
        # Race-fuzz the REAL wire (a deadlock once lived in the
        # double-vs-real-wire gap, and the chaos harness only wrapped the
        # thread double): seeded per-rank
        # scheduling jitter around every real process_allgather, with
        # digests of every gathered matrix for the parent's cross-rank
        # agreement check.
        comm = ChaosCommunicator(comm, seed=3, delay_s=0.02)
        mode = mode[len("chaos-"):]

    pct, pcs, R_true, t_true = _problem()
    m = dist.MultiHostGoICP(
        pct, pcs, comm, mse_threshold=5e-4,
        engine=std_engine(multihost_sync_every=2, multihost_steal_max=8,
                          multihost_timeout_s=300.0, outer_mode=mode,
                          so3_capacity=2048),
        bound_backend="exact")
    R, t = m.run()
    print("RESULT " + json.dumps({
        "rank": rank, "best_sse": float(m.best_sse), "mse": float(m.mse),
        "sync_rounds": m.sync_rounds,
        "donated": m.donated_nodes, "stolen": m.stolen_nodes,
        "digests": [d.hex() for d in comm.digests] if chaos else None,
        "R": np.asarray(R, np.float64).tolist(),
        "t": np.asarray(t, np.float64).tolist()}), flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_two_processes(mode: str):
    port = _free_port()
    coord = f"localhost:{port}"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # One device per process: the multi-host layer must not depend on the
    # virtual 8-device mesh the rest of the suite uses.
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    env.pop("FGOICP_TEST_REEXEC", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank), coord, mode],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=900)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    results = []
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-4000:]}"
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert line, f"no RESULT line:\n{out[-4000:]}"
        results.append(json.loads(line[-1][len("RESULT "):]))

    pct, pcs, R_true, t_true = _problem()
    by_rank = sorted(results, key=lambda r: r["rank"])
    assert [r["rank"] for r in by_rank] == [0, 1]
    for r in by_rank:
        assert r["mse"] < 5e-4
        np.testing.assert_allclose(np.asarray(r["R"]), R_true, atol=2e-3)
        np.testing.assert_allclose(np.asarray(r["t"]), t_true, atol=2e-3)
    # Both hosts took the identical number of collective rounds (the
    # protocol's pure-function-of-the-matrix invariant over a real wire)
    # and every donated node landed in exactly one heap.
    assert by_rank[0]["sync_rounds"] == by_rank[1]["sync_rounds"]
    assert (by_rank[0]["donated"] + by_rank[1]["donated"]
            == by_rank[0]["stolen"] + by_rank[1]["stolen"])
    # Both ended at the same global optimum.
    np.testing.assert_allclose(by_rank[0]["best_sse"],
                               by_rank[1]["best_sse"], rtol=1e-6)
    if mode.startswith("chaos-"):
        # Real-wire agreement under injected jitter: every rank executed
        # the same number of collectives AND round r's gathered matrix
        # is bit-identical across ranks (chaos.verify_agreement, applied
        # cross-process via the digest transcripts).
        d0, d1 = by_rank[0]["digests"], by_rank[1]["digests"]
        assert d0 is not None and d1 is not None
        assert len(d0) == len(d1), (
            f"protocol divergence under chaos: {len(d0)} vs {len(d1)} "
            f"collective rounds")
        for r, (a, b) in enumerate(zip(d0, d1)):
            assert a == b, (
                f"protocol divergence under chaos: round {r} gathered "
                f"matrices differ across ranks")
        assert len(d0) > 0


@pytest.mark.slow
@pytest.mark.skipif(
    os.environ.get("FGOICP_SLOW") != "1",
    reason="opt-in: real 2-process jax.distributed run (set FGOICP_SLOW=1)")
def test_two_process_jax_distributed_end_to_end():
    _run_two_processes("host")


@pytest.mark.slow
@pytest.mark.skipif(
    os.environ.get("FGOICP_SLOW") != "1",
    reason="opt-in: real 2-process jax.distributed run (set FGOICP_SLOW=1)")
def test_two_process_chaos_real_wire():
    """ChaosCommunicator wrapping the REAL JaxProcessCommunicator:
    seeded per-rank jitter around every process_allgather, cross-rank
    digest agreement asserted in the parent."""
    _run_two_processes("chaos-host")


@pytest.mark.slow
@pytest.mark.skipif(
    os.environ.get("FGOICP_SLOW") != "1",
    reason="opt-in: real 2-process jax.distributed run (set FGOICP_SLOW=1)")
def test_two_process_jax_distributed_device_outer():
    """Same real wire, outer_mode='device': partitioned chunked device
    BnB with incumbent sync + frontier-row stealing between chunks
    (distributed.py:_bnb_so3_device_multihost)."""
    _run_two_processes("device")


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2],
            sys.argv[3] if len(sys.argv) > 3 else "host")
