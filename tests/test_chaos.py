"""Race-fuzz of the multi-host collective protocol (parallel/chaos.py).

The protocol's deadlock protection is structural — every termination /
adoption / steal decision must be a pure function of the all-gathered
matrix.  These tests inject seeded per-rank scheduling jitter around
every collective and assert the invariants a scheduling race would
break: lockstep collective counts, bit-identical gathered matrices,
work-stealing node conservation, and the global optimum itself.
"""
import threading

import numpy as np
import pytest

from util import std_engine
from test_distributed import _problem
from fgoicp.parallel import chaos
from fgoicp.parallel import distributed as dist


def _run_chaos_hosts(n_hosts, pct, pcs, seed, engine_kw):
    comms = chaos.ChaosCommunicator.wrap_all(
        dist.ThreadCommunicator.create(n_hosts), seed=seed, delay_s=0.01)
    models = [None] * n_hosts
    results = [None] * n_hosts
    errors = []

    def host(rank):
        try:
            m = dist.MultiHostGoICP(
                pct, pcs, comms[rank], mse_threshold=5e-4,
                engine=std_engine(**engine_kw), bound_backend="exact")
            models[rank] = m
            results[rank] = m.run()
        except Exception as e:  # pragma: no cover
            errors.append((rank, e))

    threads = [threading.Thread(target=host, args=(r,))
               for r in range(n_hosts)]
    for t_ in threads:
        t_.start()
    for t_ in threads:
        t_.join(timeout=600)
    assert not errors, errors
    assert all(r is not None for r in results), "a host deadlocked"
    return comms, models, results


@pytest.mark.parametrize("seed", [0, 1])
def test_chaos_host_mode_invariants(seed):
    """4 jittered hosts, k-step sync + stealing: every rank must see the
    identical collective sequence and reach the global optimum."""
    pct, pcs, R_true, t_true = _problem()
    comms, models, results = _run_chaos_hosts(
        4, pct, pcs, seed,
        dict(multihost_sync_every=3, multihost_steal_max=8))
    rounds = chaos.verify_agreement(comms)
    assert rounds >= models[0].sync_rounds  # sync + steal collectives
    chaos.verify_conservation(models)
    for m in models:
        assert m.mse < 5e-4
    for (R, t) in results:
        np.testing.assert_allclose(R, R_true, atol=2e-3)
        np.testing.assert_allclose(t, t_true, atol=2e-3)


def test_chaos_device_mode_invariants():
    """The chunked device-outer protocol under the same jitter."""
    pct, pcs, R_true, t_true = _problem()
    comms, models, results = _run_chaos_hosts(
        2, pct, pcs, 7,
        dict(outer_mode="device", so3_capacity=2048,
             multihost_sync_every=2, multihost_steal_max=4))
    chaos.verify_agreement(comms)
    chaos.verify_conservation(models)
    for (R, t) in results:
        np.testing.assert_allclose(R, R_true, atol=2e-3)
        np.testing.assert_allclose(t, t_true, atol=2e-3)


def test_verify_agreement_detects_divergence():
    """The checker itself must catch both divergence shapes."""
    comms = chaos.ChaosCommunicator.wrap_all(
        dist.ThreadCommunicator.create(2), delay_s=0.0)

    def gather(rank, vec):
        return comms[rank].allgather(np.asarray(vec, np.float64))

    # One agreed round.
    out = [None, None]
    ts = [threading.Thread(target=lambda r=r: out.__setitem__(
        r, gather(r, [r, 1.0]))) for r in range(2)]
    for t_ in ts:
        t_.start()
    for t_ in ts:
        t_.join(timeout=30)
    assert chaos.verify_agreement(comms) == 1
    # Lockstep violation: rank 0 records an extra digest.
    comms[0].digests.append(b"extra")
    with pytest.raises(AssertionError, match="differing collective"):
        chaos.verify_agreement(comms)
    comms[0].digests.pop()
    # Agreement violation: tamper with one rank's recorded matrix digest.
    comms[1].digests[0] = b"tampered"
    with pytest.raises(AssertionError, match="matrices differ"):
        chaos.verify_agreement(comms)


def test_verify_conservation_detects_leak():
    class M:
        def __init__(self, d, s):
            self.donated_nodes, self.stolen_nodes = d, s

    chaos.verify_conservation([M(3, 1), M(0, 2)])
    with pytest.raises(AssertionError, match="conservation"):
        chaos.verify_conservation([M(3, 1), M(0, 1)])
