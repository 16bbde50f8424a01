"""Smoke run of the Go-ICP engine on one NVIDIA GPU, in one process.

Drives the entry points a user calls (the CLI's run(argv), the GoICP
class, the CLI's --serve mode) at the repo's operating points, on clouds
generated from --seed and written as PLY with TOML configs under --out,
and compares every Pallas kernel with its plain XLA reference at real
widths.  Phases:

  1. device: a GPU must be JAX's first device; prints the card's name and
     power limit (nvidia-smi, run in a child that does not import JAX);
  2. kernels: scripts/kernel_check.py at real widths, plus lb <= exact
     SSE <= ub on sampled fixed-rotation nodes;
  3. registrations through the CLI: (a) bunny scale (17,953-pt target,
     3,037-pt source), default engine; (b) the same search-only, outer
     loop on the host; (c) search-only, outer loop on the device;
     (d) full resolution (98,359-pt target, 10,000-pt source);
     (e) a half-space crop of the source, trimmed (trim_fraction 0.3);
     (f) the LUT bound backend at lut_resolution 0.002 (GoICP class);
  4. serving: --serve over 32 scans of ~8,000 points at random poses
     against a 6,000-pt target.

Every registration must recover the known pose (max-abs 5e-3 on R, 5e-3
relative to max |t| on t; serving, against a sparser target, 2e-2 on R
and 1e-2 of the cloud's span on t) and certify (mse <= mse_threshold).  Steady-state seconds
(second run) are printed beside the card's name; they are not a
benchmark.  The last line of stdout is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

    python chip_smoke.py [--seed 0] [--out chiprun_out/smoke]
    python chip_smoke.py --four-cards   # only the sharded mesh path

--four-cards runs the search-only bunny-scale registration on meshes
(cubes, points) = (4, 1) and (2, 2) with the outer loop on the host and
(4, 1) on the device, __graft_entry__.dryrun_multichip(4), and the same
registration on device 0 alone; all must certify and agree on the pose.

Any failed check raises, so the script exits non-zero without printing
the result line; so does a run where JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import tomllib

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Poses far from identity (rotation angle in radians, random axis), so an
# ICP from identity misses and the search does the work.
BUNNY = dict(cloud=35947, target=17953, source=3037, angle=2.0)
FULL = dict(cloud=98359, source=10000, angle=1.8)
SERVE = dict(target=6000, scans=32, source=8000)
LUT_RESOLUTION = 0.002
MSE = 1e-3


def log(msg):
    print(f"[smoke] {msg}", flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def pose_error(R, t, R_true, t_true):
    """(max-abs R error, max-abs t error relative to max |t_true|)."""
    return (float(np.abs(np.asarray(R) - R_true).max()),
            float(np.abs(np.asarray(t) - t_true).max()
                  / max(float(np.abs(t_true).max()), 1e-9)))


def device_phase(need):
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < need:
        print(f"chip_smoke: needs {need} GPU(s), JAX found "
              f"{[d.platform for d in devs]}", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    log(f"device_kind={devs[0].device_kind} count={len(devs)}")
    print(smi[0], flush=True)
    return devs, smi[0]


def kernel_phase(seed):
    """Kernel-vs-reference equality, then bound validity on the GPU."""
    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import kernel_check

    from fgoicp.io import synthetic
    from fgoicp.ops import bounds as bounds_ops
    from fgoicp.ops import geometry as geo
    from fgoicp.ops import nn as nn_ops

    ok, lines = kernel_check.run_check(seed=seed, memory=True)
    for ln in lines:
        log(f"kernel_check {ln}")
    check(ok, "a kernel disagrees with its XLA reference")

    # lb <= exact SSE at the node centre <= ub for fixed-rotation nodes
    # (gamma_r = 0), through evaluate_bounds and the lane kernel.
    rng = np.random.default_rng(seed)
    cloud = synthetic.bumpy_surface(BUNNY["cloud"], seed=seed)
    pct, pcs, _, _ = synthetic.known_pose_pair(
        cloud, BUNNY["target"], BUNNY["source"], seed=seed)
    norm = geo.Normalization(pct, pcs)
    backend = bounds_ops.make_backend(norm.pct, kind="proxy",
                                      proxy_size=1024, seed=seed)
    g, b = 4, 8
    R = geo.quat_cube_to_matrix(jnp.asarray(
        rng.uniform(-0.5, 0.5, size=(g, 3)), jnp.float32))
    tc = jnp.asarray(rng.uniform(-0.3, 0.3, size=(g, b, 3)), jnp.float32)
    lb, ub = bounds_ops.evaluate_bounds(
        backend, norm.pcs, R, jnp.full((g,), 0.1), jnp.ones((g,), bool),
        tc, jnp.full((g, b), 0.05))
    exact = np.array([[float(nn_ops.exact_sse(norm.pct, norm.pcs, R[i],
                                              tc[i, j]))
                       for j in range(b)] for i in range(g)])
    check(np.all(np.asarray(lb) <= exact * (1 + 1e-5) + 1e-6)
          and np.all(exact <= np.asarray(ub) * (1 + 1e-5) + 1e-6),
          "lb <= exact SSE <= ub violated on sampled nodes")
    log(f"bound validity: {g * b} nodes, lb <= exact SSE <= ub")


def write_config(path, target, source, output, trim=0.0, engine=None):
    lines = ["[io]", f"target = {json.dumps(target)}",
             f"source = {json.dumps(source)}",
             f"output = {json.dumps(output)}", "", "[params]",
             f"trim = {'true' if trim else 'false'}",
             f"trim_fraction = {trim or 0.1}",
             "target_subsample = 1.0",
             # The reference schema caps source_subsample at 0.5; source
             # files hold twice the points a case registers.
             "source_subsample = 0.5",
             f"lut_resolution = {LUT_RESOLUTION}",
             f"mse_threshold = {MSE}", "", "[engine]"]
    for k, v in (engine or {}).items():
        lines.append(f"{k} = {json.dumps(v)}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def cli_case(name, out, cfg_kw, truth, card, argv_extra=(), runs=2):
    """Register through run(argv) `runs` times; check pose + certificate
    of the last run.  Returns (R, t, steady seconds)."""
    from fgoicp.__main__ import run

    cfg = os.path.join(out, f"{name}.toml")
    res = os.path.join(out, f"{name}.result.toml")
    write_config(cfg, output=res, **cfg_kw)
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        rc = run(["-c", cfg, *argv_extra])
        walls.append(time.perf_counter() - t0)
        check(rc == 0, f"{name}: CLI exit code {rc}")
    with open(res, "rb") as f:
        r = tomllib.load(f)["result"]
    R, t = np.asarray(r["rotation"]), np.asarray(r["translation"])
    er, et = pose_error(R, t, *truth)
    log(f"{name}: mse={r['mse']:.4g} R err={er:.2e} t err={et:.2e} "
        f"cold {walls[0]:.2f} s, steady {walls[-1]:.2f} s on {card}")
    check(r["mse"] <= MSE * (1 + 1e-6),
          f"{name}: not certified (mse {r['mse']:.4g})")
    check(er < 5e-3 and et < 5e-3, f"{name}: pose not recovered "
          f"(R err {er:.2e}, t err {et:.2e})")
    return R, t, walls[-1]


def bunny_files(out, seed):
    """Bunny-scale PLY pair; returns (target path, source path, truth)."""
    from fgoicp.io import synthetic, write_ply
    cloud = synthetic.bumpy_surface(BUNNY["cloud"], seed=seed)
    pct, pcs, R, t = synthetic.known_pose_pair(
        cloud, BUNNY["target"], 2 * BUNNY["source"], seed=seed + 1,
        angle=BUNNY["angle"])
    tp, sp = os.path.join(out, "bunny_target.ply"), os.path.join(
        out, "bunny_source.ply")
    write_ply(tp, pct)
    write_ply(sp, pcs)
    return tp, sp, (R, t)


def registration_phase(out, seed, card):
    from fgoicp.config import EngineConfig
    from fgoicp.io import load_cloud, synthetic, write_ply
    from fgoicp.models.goicp import GoICP

    tp, sp, truth = bunny_files(out, seed)
    pair = dict(target=tp, source=sp)
    cli_case("a_bunny_default", out, pair, truth, card)
    cli_case("b_bunny_search_host", out,
             dict(pair, engine={"icp_multi_start": False}), truth, card)
    cli_case("c_bunny_search_device", out,
             dict(pair, engine={"icp_multi_start": False,
                                "outer_mode": "device"}), truth, card)

    cloud = synthetic.bumpy_surface(FULL["cloud"], seed=seed + 2)
    pct, pcs, R, t = synthetic.known_pose_pair(
        cloud, FULL["cloud"], 2 * FULL["source"], seed=seed + 3,
        angle=FULL["angle"])
    ftp, fsp = (os.path.join(out, "full_target.ply"),
                os.path.join(out, "full_source.ply"))
    write_ply(ftp, pct)
    write_ply(fsp, pcs)
    cli_case("d_full_resolution", out,
             dict(target=ftp, source=fsp,
                  engine={"icp_multi_start": False}), (R, t), card)

    # Half-space crop of the source against the whole target.
    rng = np.random.default_rng(seed + 4)
    cloud = synthetic.bumpy_surface(BUNNY["cloud"], seed=seed)
    nrm = rng.normal(size=3)
    part = cloud[(cloud - cloud.mean(axis=0)) @ nrm > 0]
    _, pcs, R, t = synthetic.known_pose_pair(
        part, 2 * BUNNY["source"], 2 * BUNNY["source"], seed=seed + 5,
        angle=BUNNY["angle"])
    ctp, csp = (os.path.join(out, "crop_target.ply"),
                os.path.join(out, "crop_source.ply"))
    write_ply(ctp, cloud[rng.choice(len(cloud), BUNNY["target"],
                                    replace=False)])
    write_ply(csp, pcs)
    cli_case("e_crop_trimmed", out,
             dict(target=ctp, source=csp, trim=0.3), (R, t), card)

    # The LUT backend is a GoICP argument, not a CLI option.
    pct = load_cloud(tp, 1.0, seed=0)
    pcs = load_cloud(sp, 0.5, seed=1)
    walls = []
    for _ in range(2):
        model = GoICP(pct, pcs, lut_resolution=LUT_RESOLUTION,
                      mse_threshold=MSE, bound_backend="lut",
                      engine=EngineConfig(icp_multi_start=False))
        t0 = time.perf_counter()
        R, t = model.run()
        walls.append(time.perf_counter() - t0)
    er, et = pose_error(R, t, *truth)
    log(f"f_bunny_lut_res{LUT_RESOLUTION}: mse={model.mse:.4g} "
        f"R err={er:.2e} t err={et:.2e} run cold {walls[0]:.2f} s, "
        f"steady {walls[1]:.2f} s on {card}")
    check(model.mse <= MSE * (1 + 1e-6), "LUT case not certified")
    check(er < 5e-3 and et < 5e-3, "LUT case: pose not recovered")


def serving_phase(out, seed, card):
    from fgoicp.__main__ import run
    from fgoicp.io import synthetic, write_ply

    rng = np.random.default_rng(seed + 6)
    cloud = synthetic.bumpy_surface(FULL["cloud"], seed=seed + 2)
    tp = os.path.join(out, "serve_target.ply")
    write_ply(tp, cloud[rng.choice(len(cloud), SERVE["target"],
                                   replace=False)])
    scan_dir = os.path.join(out, "scans")
    os.makedirs(scan_dir, exist_ok=True)
    span = float(np.ptp(cloud, axis=0).max())
    truths = {}
    for i in range(SERVE["scans"]):
        R = synthetic.random_rotation(rng)
        t = (rng.uniform(-0.25, 0.25, size=3) * span).astype(np.float32)
        si = rng.choice(len(cloud), 2 * SERVE["source"], replace=False)
        path = os.path.join(scan_dir, f"scan_{i:02d}.ply")
        write_ply(path, synthetic.posed(cloud[si], R, t))
        truths[path] = (R, t)
    cfg = os.path.join(out, "serve.toml")
    res = os.path.join(out, "serve.result.toml")
    write_config(cfg, target=tp, source=tp, output=res)
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        rc = run(["-c", cfg, "--serve", os.path.join(scan_dir, "*.ply")])
        walls.append(time.perf_counter() - t0)
        check(rc == 0, f"serving: CLI exit code {rc} (uncertified pairs)")
    with open(res, "rb") as f:
        r = tomllib.load(f)
    pairs = list(r.get("pair", {}).values())
    check(len(pairs) == SERVE["scans"], f"serving: {len(pairs)} results")
    # Serving certifies mse <= 1e-3 against a 6,000-pt target whose
    # sampling floor is ~6e-5, and the 6,000-pt subsample displaces the
    # SSE optimum itself from the true pose (an ICP run to convergence
    # FROM the true pose settles up to ~2.5e-3 away in R on this
    # surface).  A certified serving pose may therefore sit ~1e-2 from
    # the truth; a wrong basin sits >= 0.1 away.  So serving is held to
    # 2e-2 on R, and t to 1e-2 of the cloud's span (as bench.py's
    # serving lines judge t), since the displacement does not shrink
    # with the true shift.
    worst = (0.0, 0.0)
    for p in pairs:
        check(p["certified"], f"serving: {p['source']} not certified")
        R_true, t_true = truths[p["source"]]
        er = float(np.abs(np.asarray(p["rotation"]) - R_true).max())
        et = float(np.abs(np.asarray(p["translation"]) - t_true).max()
                   / span)
        worst = (max(worst[0], er), max(worst[1], et))
        check(er < 2e-2 and et < 1e-2,
              f"serving: {p['source']} pose not recovered "
              f"(R err {er:.2e}, t err / span {et:.2e})")
    log(f"serving: {len(pairs)} pairs certified and recovered, worst R "
        f"err {worst[0]:.2e}, t err / span {worst[1]:.2e}; cold {walls[0]:.2f} "
        f"s, steady {walls[1]:.2f} s ({len(pairs) / walls[1]:.2f} "
        f"pairs/s) on {card}")


def four_card_phase(out, seed, card):
    sys.path.insert(0, ROOT)
    import __graft_entry__

    tp, sp, truth = bunny_files(out, seed)
    pair = dict(target=tp, source=sp)
    poses = {}
    for name, mesh, mode in (("mesh_4x1_host", (4, 1), "host"),
                             ("mesh_2x2_host", (2, 2), "host"),
                             ("mesh_4x1_device", (4, 1), "device"),
                             ("single_card", (1, 1), "host")):
        poses[name] = cli_case(
            name, out,
            dict(pair, engine={"icp_multi_start": False,
                               "outer_mode": mode}), truth, card,
            argv_extra=("--mesh-cubes", str(mesh[0]),
                        "--mesh-points", str(mesh[1])))
    R1, t1, _ = poses["single_card"]
    for name, (R, t, _) in poses.items():
        er, et = pose_error(R, t, R1, t1)
        check(er < 5e-3 and et < 5e-3,
              f"{name} disagrees with the single card ({er:.2e}, {et:.2e})")
    t0 = time.perf_counter()
    __graft_entry__.dryrun_multichip(4)
    log(f"dryrun_multichip(4) passed in {time.perf_counter() - t0:.2f} s")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "smoke"))
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded (cubes x points) mesh path "
                         "on four GPUs and what it is compared with")
    args = ap.parse_args()
    devs, card = device_phase(4 if args.four_cards else 1)
    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    if args.four_cards:
        four_card_phase(args.out, args.seed, card)
    else:
        kernel_phase(args.seed)
        log(f"phase 2 done at {time.perf_counter() - t0:.1f} s")
        registration_phase(args.out, args.seed, card)
        log(f"phase 3 done at {time.perf_counter() - t0:.1f} s")
        serving_phase(args.out, args.seed, card)
        log(f"phase 4 done at {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
