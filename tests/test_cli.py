"""CLI surface: config-driven end-to-end run, output + visualization."""
import subprocess
import sys
import tomllib

import numpy as np
import pytest

from fgoicp.io import write_ply, read_ply_vertices
from fgoicp.__main__ import run as cli_run


def _make_pair(tmp_path, n=200, seed=0):
    rng = np.random.default_rng(seed)
    pct = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    ang = 0.35
    R = np.array([[np.cos(ang), -np.sin(ang), 0],
                  [np.sin(ang), np.cos(ang), 0],
                  [0, 0, 1]], np.float32)
    t = np.array([0.1, -0.05, 0.2], np.float32)
    pcs = pct[:120] @ R.T + t
    tgt = tmp_path / "target.ply"
    src = tmp_path / "source.ply"
    write_ply(str(tgt), pct)
    write_ply(str(src), pcs)
    return tgt, src, R, t


def test_cli_end_to_end(tmp_path):
    tgt, src, R_true, t_true = _make_pair(tmp_path)
    out_toml = tmp_path / "result.toml"
    viz = tmp_path / "aligned.ply"
    cfg = tmp_path / "run.toml"
    cfg.write_text(f"""
[io]
target = "{tgt}"
source = "{src}"
output = "{out_toml}"
visualization = "{viz}"

[params]
target_subsample = 1.0
source_subsample = 0.5
mse_threshold = 1e-4

[engine]
rotation_batch = 2
frontier_capacity = 512
pool_lanes = 256
pool_capacity = 8192
""")
    rc = cli_run(["-c", str(cfg)])
    assert rc == 0
    result = tomllib.load(open(out_toml, "rb"))
    # Registration maps source -> target: R ~= R_true^T.
    R = np.asarray(result["result"]["rotation"])
    err = np.abs(R @ R_true - np.eye(3)).max()
    assert err < 2e-2, f"rotation recovery error {err}"
    assert result["result"]["mse"] < 1e-3
    aligned = read_ply_vertices(str(viz))
    assert aligned.shape[1] == 3 and len(aligned) > 0


def test_cli_resume_roundtrip(tmp_path):
    """--resume picks up the checkpoint written by a prior run."""
    tgt, src, R_true, t_true = _make_pair(tmp_path, seed=4)
    ckpt = tmp_path / "bnb.npz"
    cfg = tmp_path / "run.toml"
    cfg.write_text(f"""
[io]
target = "{tgt}"
source = "{src}"

[params]
source_subsample = 0.5
mse_threshold = 1e-4

[engine]
rotation_batch = 2
frontier_capacity = 512
pool_lanes = 256
pool_capacity = 8192
icp_multi_start = false
checkpoint_path = "{ckpt}"
checkpoint_every = 1
""")
    assert cli_run(["-c", str(cfg)]) == 0
    if ckpt.exists():  # a search ran and checkpointed
        assert cli_run(["-c", str(cfg), "--resume"]) == 0


def test_cli_requires_config():
    with pytest.raises(SystemExit):
        cli_run([])


def test_make_test_pair_script(tmp_path):
    rng = np.random.default_rng(1)
    cloud = tmp_path / "cloud.ply"
    write_ply(str(cloud), rng.uniform(-1, 1, size=(500, 3)).astype(np.float32))
    out = tmp_path / "pair.ply"
    truth = tmp_path / "truth.toml"
    res = subprocess.run(
        [sys.executable, "scripts/make_test_pair.py", str(cloud), str(out),
         "--fraction", "0.2", "--seed", "3", "--truth", str(truth)],
        capture_output=True, text=True, cwd="/root/repo")
    assert res.returncode == 0, res.stderr
    pts = read_ply_vertices(str(out))
    assert 1 <= len(pts) <= 120
    tr = tomllib.load(open(truth, "rb"))
    R = np.asarray(tr["truth"]["rotation"])
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-12)


def test_cli_serve_batch(tmp_path):
    """--serve registers a glob of scans against the config target in one
    batched service call and writes a [pair.N] section per cloud."""
    rng = np.random.default_rng(7)
    pct = rng.uniform(-1, 1, size=(400, 3)).astype(np.float32)
    tgt = tmp_path / "target.ply"
    write_ply(str(tgt), pct)
    Rs = []
    for i in range(3):
        ang = 0.2 + 0.1 * i
        R = np.array([[np.cos(ang), -np.sin(ang), 0],
                      [np.sin(ang), np.cos(ang), 0],
                      [0, 0, 1]], np.float32)
        t = np.array([0.05 * i, -0.04, 0.08], np.float32)
        # Ragged sizes: --serve must subsample to a common size.
        pcs = (pct[:200 + 20 * i] - t) @ R
        write_ply(str(tmp_path / f"scan{i}.ply"), pcs)
        Rs.append(R)
    out_toml = tmp_path / "serve.toml"
    cfg = tmp_path / "run.toml"
    cfg.write_text(f"""
[io]
target = "{tgt}"
source = "{tgt}"
output = "{out_toml}"

[params]
mse_threshold = 1e-3

[engine]
rotation_batch = 2
pool_lanes = 256
pool_capacity = 8192
""")
    rc = cli_run(["-c", str(cfg), "--serve", str(tmp_path / "scan*.ply")])
    assert rc == 0  # every pair certified
    result = tomllib.load(open(out_toml, "rb"))
    assert result["serve"]["pairs"] == 3
    assert result["serve"]["certified"] == 3
    for i in range(3):
        pair = result["pair"][str(i)]
        assert pair["certified"] is True
        R = np.asarray(pair["rotation"])
        np.testing.assert_allclose(R, Rs[i], atol=2e-2)


def test_cli_serve_empty_glob(tmp_path):
    tgt = tmp_path / "target.ply"
    write_ply(str(tgt), np.random.default_rng(0).uniform(
        -1, 1, size=(50, 3)).astype(np.float32))
    cfg = tmp_path / "run.toml"
    cfg.write_text(f"""
[io]
target = "{tgt}"
source = "{tgt}"
""")
    assert cli_run(["-c", str(cfg),
                    "--serve", str(tmp_path / "nope*.ply")]) == 1
