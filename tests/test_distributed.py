"""Multi-host outer BnB, simulated with thread hosts (identical protocol
semantics to the jax.distributed communicator)."""
import threading

import numpy as np
import pytest

from util import std_engine
from fgoicp.models.goicp import GoICP
from fgoicp.parallel import distributed as dist


def test_partition_root_covers_and_disjoint():
    for size in (1, 2, 3, 8, 9):
        parts = [dist.partition_root(r, size) for r in range(size)]
        cells = [c for p in parts for c in p]
        # Disjoint.
        assert len(cells) == len(set(cells))
        # Spans halve per split level; total volume equals the root cube
        # (span 1 half-span cube has volume 8).
        vol = sum((2 * c[3]) ** 3 for c in cells)
        np.testing.assert_allclose(vol, 8.0, rtol=1e-12)


def _surface_cloud(rng, n):
    s = rng.uniform(0.0, 4.5, size=(n,))  # open curve: no self-symmetry
    pts = np.stack([np.cos(s), 0.7 * np.sin(2.0 * s),
                    0.4 * np.sin(3.0 * s + 0.5)], axis=1)
    return (pts + rng.normal(scale=0.01, size=(n, 3))).astype(np.float32)


def _problem(seed=0, n=150, angle=2.1):
    rng = np.random.default_rng(seed)
    pct = _surface_cloud(rng, n)
    c, s = np.cos(angle), np.sin(angle)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    t = np.array([0.2, -0.1, 0.15], np.float32)
    pcs = (pct[:100] - t) @ R
    return pct, pcs, R, t


def test_f64_wire_roundtrip():
    """The f32 (hi, lo) wire split carries ~48 mantissa bits (vs f32's
    24): the decoded value matches the f64 original to ~2^-48 relative,
    and every host decodes the SAME value from the same bytes — the two
    properties that kill the f32-rounding termination-disagreement bug."""
    rng = np.random.default_rng(0)
    vals = np.concatenate([
        rng.uniform(-1e9, 1e9, size=(64,)),
        rng.uniform(-1e-6, 1e-6, size=(64,)),
        np.array([0.0, 1e10, -1e10, np.pi, 1.0 + 2**-40]),
    ])
    wire = dist.split_f64_to_f32_pairs(vals)
    assert wire.dtype == np.float32
    back = dist.merge_f32_pairs_to_f64(wire)
    err = np.abs(back - vals) / np.maximum(np.abs(vals), 1e-300)
    assert float(err.max()) < 2.0 ** -45
    # Values with <= 48 mantissa bits roundtrip exactly (includes every
    # f32-representable value — the heap-size and flag fields).
    exact = np.array([0.0, 1.0, 3.0, 2.5, 1e10, -7.0, 1.0 + 2**-40])
    np.testing.assert_array_equal(
        dist.merge_f32_pairs_to_f64(dist.split_f64_to_f32_pairs(exact)),
        exact)


def _run_hosts(n_hosts, pct, pcs, engine_kw):
    comms = dist.ThreadCommunicator.create(n_hosts)
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
    return models, results


def test_multihost_imbalanced_hosts_ksync_and_stealing():
    """4 hosts with unequal octant partitions, syncing every 3 outer
    steps: all hosts must converge to the global optimum (no deadlock),
    and drained hosts must pick up stolen work instead of idling."""
    pct, pcs, R_true, t_true = _problem()
    models, results = _run_hosts(
        4, pct, pcs, dict(multihost_sync_every=3, multihost_steal_max=8))
    for m in models:
        assert m.mse < 5e-4
    for (R, t) in results:
        np.testing.assert_allclose(R, R_true, atol=2e-3)
        np.testing.assert_allclose(t, t_true, atol=2e-3)
    assert all(m.sync_rounds == models[0].sync_rounds for m in models)
    donated = sum(m.donated_nodes for m in models)
    stolen = sum(m.stolen_nodes for m in models)
    assert donated == stolen  # every donated node lands in exactly one heap


def test_multihost_exhaustion_reports_open_gap():
    """Multi-host edition of the r5 bun090 regression class: with an
    UNREACHABLE threshold every rank's finite rotation tree exhausts;
    the wire must carry each rank's closed-leaf floor (msg[1]) so the
    run terminates via the exhaustion-stall exit with the certified
    gap honestly OPEN on every rank — not a fake exhaustive
    certificate."""
    rng = np.random.default_rng(33)
    pct = _surface_cloud(rng, 150)
    c, s = np.cos(1.3), np.sin(1.3)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    pcs = ((pct[:100] - 0.1) @ R
           + rng.normal(scale=0.02, size=(100, 3))).astype(np.float32)
    comms = dist.ThreadCommunicator.create(2)
    models = [None, None]
    errors = []

    def host(rank):
        try:
            m = dist.MultiHostGoICP(
                pct, pcs, comms[rank], mse_threshold=1e-9,
                engine=std_engine(rotation_min_span=0.3,
                                  icp_trigger_factor=1.8,
                                  icp_multi_start=False),
                bound_backend="exact")
            models[rank] = m
            m.run()
        except Exception as e:  # pragma: no cover
            errors.append((rank, e))

    threads = [threading.Thread(target=host, args=(r,)) for r in (0, 1)]
    for t_ in threads:
        t_.start()
    for t_ in threads:
        t_.join(timeout=600)
    assert not errors, errors
    assert all(m is not None for m in models), "a host deadlocked"
    for m in models:
        assert m.last_certified_gap is not None
        assert m.last_certified_gap > m.sse_threshold
        assert m.best_sse < 1e10
    # the gap is a pure function of the shared matrix: ranks agree
    assert models[0].last_certified_gap == models[1].last_certified_gap


def test_host_checkpoint_roundtrips_closed_leaf_floor(tmp_path):
    """_closed_leaf_lb survives save/load: a resumed exhausted search
    must not forget the leaves the dead process already closed."""
    pct, pcs, _, _ = _problem()
    m = GoICP(pct, pcs, mse_threshold=5e-4, engine=std_engine(),
              bound_backend="exact")
    m.best_sse = 3.0
    m.best_rotation = np.eye(3, dtype=np.float32)
    m.best_translation = np.zeros(3, np.float32)
    m.seed_heap()
    m._closed_leaf_lb = 0.125
    p = str(tmp_path / "ck.npz")
    m.save_checkpoint(p)
    m2 = GoICP(pct, pcs, mse_threshold=5e-4, engine=std_engine(),
               bound_backend="exact")
    m2.load_checkpoint(p)
    assert m2._closed_leaf_lb == 0.125


def test_work_stealing_transfers_nodes():
    """Deterministic stealing mechanics: a busy host with 5 frontier
    nodes and an empty idle host — one _maybe_steal round must move
    nodes (donor keeps its best) with every node in exactly one heap."""
    pct, pcs, _, _ = _problem(seed=2)
    comms = dist.ThreadCommunicator.create(2)
    models = []
    for r in range(2):
        m = dist.MultiHostGoICP(pct, pcs, comms[r], mse_threshold=5e-4,
                                engine=std_engine(), bound_backend="exact")
        m.seed_heap()
        models.append(m)
    # Host 0: 5 nodes with distinct lbs; host 1: empty.
    import heapq
    models[0]._heap = []
    for i, lb in enumerate([0.1, 0.5, 0.3, 0.9, 0.7]):
        heapq.heappush(models[0]._heap,
                       (lb, i, (0.1 * i, 0.0, 0.0, 0.25, lb + 1.0)))
    models[1]._heap = []
    gathered = np.zeros((2, 18), np.float64)
    # last two columns: steal_max, valve_bound (0 = can absorb work)
    gathered[0] = [1e3, 0.1, 0.0] + [0.0] * 12 + [5.0, 8.0, 0.0]
    gathered[1] = [1e3, 1e10, 1.0] + [0.0] * 12 + [0.0, 8.0, 0.0]

    errors = []

    def run(rank):
        try:
            models[rank]._maybe_steal(gathered)
        except Exception as e:  # pragma: no cover
            errors.append((rank, e))

    threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t_ in threads:
        t_.start()
    for t_ in threads:
        t_.join(timeout=60)
    assert not errors, errors
    assert models[0].donated_nodes == 4
    assert models[1].stolen_nodes == 4
    # Donor kept exactly its best node.
    assert len(models[0]._heap) == 1
    assert models[0]._heap[0][0] == 0.1
    # Recipient got the other four, best-first order preserved by lb.
    got = sorted(e[0] for e in models[1]._heap)
    np.testing.assert_allclose(got, [0.3, 0.5, 0.7, 0.9])


def test_steal_plan_skips_valve_bound_hosts():
    """A device-mode host idled by the outer-step valve votes idle for
    termination but CANNOT expand donated work — the steal plan must
    route nodes only to absorbing idle hosts, and must not run the
    payload collective at all when every idle host is valve-bound."""
    pct, pcs, _, _ = _problem(seed=2)
    comm = dist.ThreadCommunicator.create(1)[0]
    m = dist.MultiHostGoICP(pct, pcs, comm, mse_threshold=5e-4,
                            engine=std_engine(), bound_backend="exact")
    # 3 hosts: busy donor, valve-bound idle, absorbing idle.
    g = np.zeros((3, 18), np.float64)
    g[0] = [1e3, 0.1, 0.0] + [0.0] * 12 + [5.0, 8.0, 0.0]
    g[1] = [1e3, 0.2, 1.0] + [0.0] * 12 + [3.0, 8.0, 1.0]  # valve-bound
    g[2] = [1e3, 1e10, 1.0] + [0.0] * 12 + [0.0, 8.0, 0.0]
    steal_max, donor, absorbing, n_abs = m._steal_plan(g)
    assert donor == 0 and n_abs == 1
    np.testing.assert_array_equal(absorbing, [False, False, True])
    # Every idle host valve-bound: no steal (None = skip the collective
    # on ALL hosts — the decision is a pure function of the matrix).
    g[2, 17] = 1.0
    assert m._steal_plan(g) is None


def test_device_valve_is_relative_to_resume():
    """Elastic recovery SUMS per-host outer_steps when merging crash
    checkpoints (so3_frontier.merge_states); a resumed device search
    whose merged counter already exceeds the absolute valve must still
    RUN (the valve is 10000 MORE steps, not a lifetime cap)."""
    from fgoicp.models.goicp import GoICP
    from fgoicp.ops import so3_frontier as so3

    pct, pcs, R_true, t_true = _problem(seed=3)
    eng = std_engine(outer_mode="device", so3_capacity=2048)
    m = GoICP(pct, pcs, engine=eng, mse_threshold=5e-4,
              bound_backend="exact")
    st = so3.initial_state(eng.so3_capacity, best_sse=1e9)
    # Simulate a merged two-host checkpoint: counters way past the valve.
    st = st._replace(outer_steps=np.int32(3 * m._DEVICE_MAX_OUTER))
    m._resumed_so3_state = st
    R, t = m.run()
    # stats carry the post-resume DELTA: >= 1 means the device loop
    # actually expanded the resumed frontier instead of exiting on an
    # exhausted absolute valve and re-searching from the host root.
    assert m.stats.outer_steps >= 1
    np.testing.assert_allclose(np.asarray(R), R_true, atol=2e-3)
    np.testing.assert_allclose(np.asarray(t), t_true, atol=2e-3)


def test_allgather_timeout_raises_clean_error():
    """A dead peer must surface as a RuntimeError with a checkpoint
    hint, not an eternal hang (the collective can't recover in place)."""
    comms = dist.ThreadCommunicator.create(2)
    with pytest.raises(RuntimeError, match="checkpoint"):
        # Rank 1 never shows up.
        comms[0].allgather(np.zeros(4), timeout=0.5)


def test_steal_max_heterogeneous_configs_no_deadlock():
    """Hosts launched with DIFFERING multihost_steal_max must still agree
    on the steal payload shape (it rides the wire, min across hosts) and
    converge without deadlock."""
    pct, pcs, R_true, t_true = _problem(seed=3)
    comms = dist.ThreadCommunicator.create(2)
    models = [None, None]
    results = [None, None]
    errors = []

    def host(rank):
        try:
            m = dist.MultiHostGoICP(
                pct, pcs, comms[rank], mse_threshold=5e-4,
                engine=std_engine(multihost_sync_every=2,
                                  multihost_steal_max=4 if rank == 0 else 12),
                bound_backend="exact")
            models[rank] = m
            results[rank] = m.run()
        except Exception as e:  # pragma: no cover
            errors.append((rank, e))

    threads = [threading.Thread(target=host, args=(r,)) for r in range(2)]
    for t_ in threads:
        t_.start()
    for t_ in threads:
        t_.join(timeout=600)
    assert not errors, errors
    assert all(r is not None for r in results), "a host deadlocked"
    for (R, t) in results:
        np.testing.assert_allclose(R, R_true, atol=2e-3)
        np.testing.assert_allclose(t, t_true, atol=2e-3)
    assert sum(m.donated_nodes for m in models) == \
        sum(m.stolen_nodes for m in models)


def test_elastic_recovery_merges_host_checkpoints(tmp_path):
    """Elastic recovery (GoICP.load_checkpoints): a 2-host partitioned
    run dies mid-search; a SINGLE host resumes from the union of both
    per-host checkpoints and still reaches the global optimum.  The
    union matters — each checkpoint holds only its partition's
    frontier, so resuming one alone would drop the other's subtrees."""
    pct, pcs, R_true, t_true = _problem()
    comms = dist.ThreadCommunicator.create(2)
    paths = [str(tmp_path / f"host{r}.npz") for r in range(2)]
    models = []
    for r in range(2):
        m = dist.MultiHostGoICP(pct, pcs, comms[r], mse_threshold=5e-4,
                                engine=std_engine(), bound_backend="exact")
        m._initial_icp()
        m.seed_heap()
        models.append(m)
    # A few local outer steps per host with NO sync rounds (the
    # coordinator "died"), then each host's crash checkpoint.
    for r, m in enumerate(models):
        for _ in range(2):
            if m._heap:
                m.outer_step()
        m.save_checkpoint(paths[r])

    fresh = GoICP(pct, pcs, mse_threshold=5e-4, engine=std_engine(),
                  bound_backend="exact")
    fresh.run()

    rec = GoICP(pct, pcs, mse_threshold=5e-4, engine=std_engine(),
                bound_backend="exact")
    rec.load_checkpoints(paths)
    R, t = rec.run()
    assert rec.mse < 5e-4
    np.testing.assert_allclose(R, R_true, atol=2e-3)
    np.testing.assert_allclose(t, t_true, atol=2e-3)
    assert abs(rec.best_sse - fresh.best_sse) <= \
        1e-3 * max(fresh.best_sse, 1e-9) + 1e-9


def test_multihost_device_mode_matches():
    """outer_mode='device' multi-host (round 3): each host runs its
    SO(3) partition as chunked device calls (one jitted nested BnB per
    chunk) with incumbent sync rounds between chunks; work stealing
    moves frontier rows between device states host-side."""
    pct, pcs, R_true, t_true = _problem()
    models, results = _run_hosts(
        2, pct, pcs, dict(outer_mode="device", so3_capacity=2048,
                          multihost_sync_every=2, multihost_steal_max=4))
    for m in models:
        assert m.mse < 5e-4
    for (R, t) in results:
        np.testing.assert_allclose(R, R_true, atol=2e-3)
        np.testing.assert_allclose(t, t_true, atol=2e-3)
    assert all(m.sync_rounds == models[0].sync_rounds for m in models)
    assert sum(m.donated_nodes for m in models) == \
        sum(m.stolen_nodes for m in models)


@pytest.mark.parametrize("n_hosts", [2])
def test_multihost_matches_single_host(n_hosts):
    pct, pcs, R_true, t_true = _problem()
    eng = std_engine()

    single = GoICP(pct, pcs, mse_threshold=5e-4, engine=eng,
                   bound_backend="exact")
    single.run()

    comms = dist.ThreadCommunicator.create(n_hosts)
    models = [None] * n_hosts
    results = [None] * n_hosts
    errors = []

    def host(rank):
        try:
            m = dist.MultiHostGoICP(
                pct, pcs, comms[rank], mse_threshold=5e-4,
                engine=std_engine(),
                bound_backend="exact")
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
    assert all(r is not None for r in results)

    # Every host ends at the same global optimum as the single-host run.
    for m in models:
        assert m.best_sse <= single.best_sse * 1.01 + 1e-9
        assert m.mse < 5e-4
    for (R, t) in results:
        np.testing.assert_allclose(R, R_true, atol=2e-3)
        np.testing.assert_allclose(t, t_true, atol=2e-3)
    # The cube partition actually split the work.
    total_children = sum(m.stats.rotation_children for m in models)
    assert total_children > 0
    assert all(m.sync_rounds == models[0].sync_rounds for m in models)
