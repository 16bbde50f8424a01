"""Checkpoint/resume of the Go-ICP search state."""
import numpy as np
import pytest

from util import std_engine
from fgoicp.models.goicp import GoICP
from fgoicp.utils import checkpoint as ckpt


def _pair(seed=0, n=150):
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.0, 4.5, size=(n,))  # open curve: no self-symmetry
    pts = np.stack([np.cos(s), 0.7 * np.sin(2.0 * s),
                    0.4 * np.sin(3.0 * s + 0.5)], axis=1)
    pct = (pts + rng.normal(scale=0.01, size=(n, 3))).astype(np.float32)
    ang = 2.2  # identity-init ICP must fail so the BnB runs and checkpoints
    R = np.array([[np.cos(ang), 0, np.sin(ang)],
                  [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]], np.float32)
    pcs = pct[:100] @ R.T + np.array([0.4, -0.2, 0.1], np.float32)
    return pct, pcs


def test_roundtrip_low_level(tmp_path):
    path = str(tmp_path / "state.npz")
    heap = [(0.5, 0, (0.1, 0.2, 0.3, 0.25, 1.5, 0.01, -0.02, 0.03)),
            (1.5, 1, (-0.1, -0.2, -0.3, 0.5, 9.9, 0.0, 0.0, 0.0))]
    ckpt.save(path, heap=heap, tie=7, best_sse=1.25,
              best_rotation=np.eye(3), best_translation=np.zeros(3),
              stats={"outer_steps": 3}, fingerprint="abc")
    st = ckpt.load(path, fingerprint="abc")
    assert st["heap"] == heap
    assert st["tie"] == 7 and st["best_sse"] == 1.25
    assert st["stats"]["outer_steps"] == 3
    with pytest.raises(ValueError, match="fingerprint"):
        ckpt.load(path, fingerprint="different")
    # Back-compat: 5-wide (pre-r5) node items load padded with t=0.
    ckpt.save(path, heap=[(0.5, 0, (0.1, 0.2, 0.3, 0.25, 1.5))],
              tie=1, best_sse=1.0, best_rotation=np.eye(3),
              best_translation=np.zeros(3), stats={}, fingerprint="abc")
    st = ckpt.load(path, fingerprint="abc")
    assert st["heap"] == [
        (0.5, 0, (0.1, 0.2, 0.3, 0.25, 1.5, 0.0, 0.0, 0.0))]


def test_goicp_resume_matches_fresh(tmp_path):
    pct, pcs = _pair()
    path = str(tmp_path / "bnb.npz")
    eng = std_engine(checkpoint_path=path, checkpoint_every=1)

    # Fresh full run = ground truth result.
    m_full = GoICP(pct, pcs, mse_threshold=5e-4, engine=eng)
    m_full.run()

    # Second model resumes from the final checkpoint of the first: it
    # should reach (at least) the same incumbent without re-seeding ICP.
    m_res = GoICP(pct, pcs, mse_threshold=5e-4, engine=std_engine())
    m_res.load_checkpoint(path)
    m_res.run()
    assert m_res.best_sse <= m_full.best_sse * 1.0001 + 1e-9
    # Resume skipped the initial ICP (stats carried over from checkpoint).
    assert m_res.stats.icp_runs >= m_full.stats.icp_runs - 1


def test_device_mode_chunked_resume(tmp_path):
    """outer_mode='device' checkpoints: the search runs in
    checkpoint_every-step chunks persisting the SO3State between device
    calls; a killed run resumes mid-search from the last chunk."""
    pct, pcs = _pair()
    path = str(tmp_path / "dev.npz")
    dev = dict(outer_mode="device", so3_capacity=2048)

    # Ground truth: one-call device run, no checkpointing.
    m_full = GoICP(pct, pcs, mse_threshold=5e-4, engine=std_engine(**dev))
    m_full.run()

    # Simulated kill: die right after the 2nd chunk checkpoint lands.
    m_int = GoICP(pct, pcs, mse_threshold=5e-4,
                  engine=std_engine(checkpoint_path=path,
                                    checkpoint_every=1, **dev))
    real_save = m_int._save_device_checkpoint
    calls = []

    def dying_save(st):
        real_save(st)
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("simulated kill")

    m_int._save_device_checkpoint = dying_save
    with pytest.raises(RuntimeError, match="simulated kill"):
        m_int.run()
    assert ckpt.peek_kind(path) == "device_state"

    # Resume from the on-disk chunk state and finish the search.
    m_res = GoICP(pct, pcs, mse_threshold=5e-4,
                  engine=std_engine(checkpoint_path=path,
                                    checkpoint_every=1, **dev))
    m_res.load_checkpoint(path)
    assert m_res.stats.outer_steps >= 1   # state carried over
    m_res.run()
    assert m_res.best_sse <= m_full.best_sse * 1.0001 + 1e-9
    assert m_res.mse < 5e-4


def test_device_mode_chunked_resume_on_mesh(tmp_path):
    """Chunked device checkpointing composes with (cubes x points)
    sharding: init_state/max_outer ride through shard_map as replicated
    arguments, so every chunk reuses one executable and a resumed run
    reaches the same optimum."""
    pct, pcs = _pair()
    path = str(tmp_path / "devmesh.npz")
    dev = dict(outer_mode="device", so3_capacity=2048,
               mesh_cubes=2, mesh_points=4,
               checkpoint_path=path, checkpoint_every=2)
    m = GoICP(pct, pcs, mse_threshold=5e-4, engine=std_engine(**dev))
    m.run()
    assert m.mse < 5e-4
    assert ckpt.peek_kind(path) == "device_state"

    m_res = GoICP(pct, pcs, mse_threshold=5e-4, engine=std_engine(**dev))
    m_res.load_checkpoint(path)
    m_res.run()
    assert abs(m_res.best_sse - m.best_sse) <= \
        1e-3 * max(m.best_sse, 1e-9) + 1e-9


def test_checkpoint_kind_mismatch(tmp_path):
    """A host-heap checkpoint refuses to resume in device mode and vice
    versa, naming the outer_mode that can."""
    pct, pcs = _pair()
    hpath = str(tmp_path / "host.npz")
    mh = GoICP(pct, pcs, mse_threshold=5e-4, engine=std_engine())
    mh._heap = []
    mh.save_checkpoint(hpath)
    md = GoICP(pct, pcs, mse_threshold=5e-4,
               engine=std_engine(outer_mode="device"))
    with pytest.raises(ValueError, match="outer_mode='host'"):
        md.load_checkpoint(hpath)

    dpath = str(tmp_path / "dev.npz")
    ckpt.save_device_state(
        dpath, state_arrays={"best_sse": np.float32(1.0)}, stats={},
        fingerprint=mh._fingerprint)
    with pytest.raises(ValueError, match="outer_mode='device'"):
        mh.load_checkpoint(dpath)


def test_checkpoint_rejects_wrong_clouds(tmp_path):
    pct, pcs = _pair()
    path = str(tmp_path / "bnb.npz")
    m = GoICP(pct, pcs, mse_threshold=5e-4)
    m._heap = []
    m.save_checkpoint(path)
    other = GoICP(pct[:-1], pcs, mse_threshold=5e-4)
    with pytest.raises(ValueError, match="fingerprint"):
        other.load_checkpoint(path)
