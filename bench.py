"""Benchmark harness: Go-ICP on the reference's canonical workloads.

Prints one JSON line per workload:
    {"metric": ..., "value": N, "unit": "s", "vs_baseline": N, ...}
The HEADLINE metric (bunny time-to-global-optimum) is the LAST line, so
`tail -1 | json` keeps working for single-metric consumers.

Workloads (reference parity):
  * bunny  — /root/reference/test/bunny.toml: model_bunny x 0.5 target,
    data_bunny x 0.1 source, mse 1e-3 (seeded subsampling; the
    reference's is nondeterministic, utilities.hpp:149-151).
  * skull  — /root/reference/test/skull_goicp.toml workload class; the
    reference's model_skull.ply is a missing large blob
    (.MISSING_LARGE_BLOBS:1), so the source is a known-transform
    perturbation of data_skull.ply and recovery is asserted.  Run twice:
    full-source bounds and hierarchical source_coreset bounds.
  * dragon — two different dragon scans (partial overlap), trimmed
    registration (trim is parsed-but-dead in the reference,
    utilities.hpp:94; functional here).
  * bunny scans — bun000 vs bun045 (the CLASSIC Go-ICP evaluation
    pair): real turntable scans, trimmed; the check asserts the
    recovered rotation matches the known ~34-degree-about-y scanner
    geometry.

The headline metric is time-to-global-optimum (the reference logs exactly
this: FastGoICP::run() wall-clock, src/main.cpp:50-55).  The reference
publishes no numbers, so vs_baseline compares against a
pinned conservative CPU-class Go-ICP wall-clock per workload (Go-ICP
paper: bunny-scale solves take tens of seconds to minutes on CPU).
Secondary stats go to stderr.  Each workload reports its SECOND run:
the first pays compilation / compile-cache loading, which the
reference's precompiled CUDA binaries never pay; cold walls go to stderr.
Every run starts with the kernel gate (scripts/kernel_check.py on the
GPU); without a GPU the bench stops before measuring anything.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

CPU_CLASS_SECONDS = 30.0  # pinned CPU-class baseline per workload

DATA = "/root/reference/data"
BUNNY_TARGET = f"{DATA}/bunny/model_bunny.txt"
BUNNY_SOURCE = f"{DATA}/bunny/data_bunny.txt"
SKULL = f"{DATA}/artec3d/data_skull.ply"
DRAGON_T = f"{DATA}/dragon/dragonClearSpace2_0.ply"
DRAGON_S = f"{DATA}/dragon/dragonToes3_0.ply"


def _log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _synthetic_pair():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(18000, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    r = 1.0 + 0.3 * np.sin(4 * v[:, :1]) + rng.normal(scale=0.005,
                                                      size=(18000, 1))
    pct = (v * r).astype(np.float32)
    idx = rng.choice(18000, size=3000, replace=False)
    ang = 1.5
    c, s = np.cos(ang), np.sin(ang)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    pcs = pct[idx] @ R.T + np.array([0.2, -0.1, 0.05], np.float32)
    return pct, pcs


def _known_transform_pair(cloud, n_target, n_source, seed=5, angle=1.8):
    """Target subsample + known-(R, t)-perturbed source subsample."""
    rng = np.random.default_rng(seed)
    cloud = np.asarray(cloud, np.float32)
    ti = rng.choice(len(cloud), size=n_target, replace=False)
    si = rng.choice(len(cloud), size=n_source, replace=False)
    c, s = np.cos(angle), np.sin(angle)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    span = float(np.ptp(cloud, axis=0).max())
    t = np.array([0.11, -0.07, 0.05], np.float32) * span
    pcs = (cloud[si] - t) @ R
    return cloud[ti], pcs, R, t


def _run_workload(name, pct, pcs, ref_seconds, engine=None, runs=2,
                  check=None, **goicp_kw):
    """Run `runs` times (first = cold), report the last; always returns
    the JSON-line dict (a failed check sets converged: false)."""
    from fgoicp.config import EngineConfig
    from fgoicp.models.goicp import GoICP

    _log(f"{name}: target={len(pct)} source={len(pcs)} pts")
    wall = None
    for i in range(runs):
        tc = time.time()
        model = GoICP(pct, pcs, engine=engine or EngineConfig(), **goicp_kw)
        _log(f"{name} construct[{i}]: {time.time() - tc:.3f}s")
        t0 = time.time()
        R, t = model.run()
        wall = time.time() - t0
        tag = "cold" if i == 0 else "steady"
        _log(f"{name} {tag}: {wall:.3f}s mse={model.mse:.3g} "
             f"nodes={model.stats.translation_nodes} "
             f"cubes/s={model.stats.cubes_per_second:.0f}")
    ok = True
    if check is not None:
        ok = bool(check(model, np.asarray(R), np.asarray(t)))
        if not ok:
            _log(f"{name}: CHECK FAILED")
    stats = model.stats
    _log(f"{name} detail: " + json.dumps({
        "mse": float(model.mse), "sse": float(model.best_sse),
        "translation_nodes": stats.translation_nodes,
        "inner_loop_steps": stats.inner_loop_steps,
        "rotation_children": stats.rotation_children,
        "icp_runs": stats.icp_runs, "outer_steps": stats.outer_steps,
        "R": np.asarray(R).tolist(), "t": np.asarray(t).tolist()}))
    return {
        "metric": name,
        "value": round(wall, 3),
        "unit": "s",
        "vs_baseline": round(ref_seconds / wall, 2),
        "converged": ok,
    }


GATE_RECORD = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "chiprun_out", "KERNELCHECK.json")


def _kernel_gate():
    """Check every Pallas kernel against its XLA reference on the GPU
    before any number is taken, and record the result (GATE_RECORD, an
    ignored path, + stderr).  A kernel that compiles but computes wrong
    values would otherwise surface only as a wrong bench number.

    Exits when JAX finds no GPU: a bench number from another device is
    not a measurement of this system.  Returns False iff the gate is
    RED; the caller stamps gate_failed into every JSON line and exits
    nonzero."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: needs a GPU, JAX found {dev.platform!r}")
    result = {"platform": dev.platform, "device_kind": dev.device_kind}
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "scripts"))
    try:
        import kernel_check
        ok, detail = kernel_check.run_check()
        result.update(ok=ok, detail=detail)
    except Exception as e:  # a crashed gate is a FAILED gate
        result.update(ok=False, detail=[f"kernel check crashed: {e!r}"])
    for ln in result["detail"]:
        _log(f"kernel_check {ln}")
    os.makedirs(os.path.dirname(GATE_RECORD), exist_ok=True)
    with open(GATE_RECORD, "w") as f:
        json.dump(result, f)
    if not result["ok"]:
        _log("kernel_check FAILED — bench numbers are INVALID "
             "(gate_failed stamped, exiting nonzero)")
    return bool(result["ok"])


def bench_skull(lines):
    if not os.path.exists(SKULL):
        _log("skull data missing; skipped")
        return
    from fgoicp.config import EngineConfig
    from fgoicp.io import load_cloud

    cloud = load_cloud(SKULL, 1.0, seed=0)
    pct, pcs, R_true, t_true = _known_transform_pair(cloud, 6000, 8000)

    def check(model, R, t):
        return (np.abs(R - R_true).max() < 5e-3
                and np.abs(t - t_true).max() < 5e-3 * np.abs(t_true).max())

    # Multi-start off: force the BnB to do the work (with it on, the
    # initial batched ICP usually lands the basin and the gap check ends
    # the run — real, but it benchmarks ICP, not the search).
    for tag, coreset in (("full_source", 0), ("source_coreset", 2048)):
        eng = EngineConfig(icp_multi_start=False, source_coreset=coreset)
        lines.append(_run_workload(
            f"skull_known_transform_{tag}", pct, pcs, CPU_CLASS_SECONDS,
            engine=eng, mse_threshold=1e-3, check=check))
    # Same coreset search with the whole nested BnB in ONE device call.
    lines.append(_run_workload(
        "skull_coreset_device_outer", pct, pcs, CPU_CLASS_SECONDS,
        engine=EngineConfig(icp_multi_start=False, source_coreset=2048,
                            outer_mode="device"),
        mse_threshold=1e-3, check=check))

    # Full-resolution workload: the ENTIRE
    # 98,359-point skull as target, 10k-point source — the largest cloud
    # the reference ships (its own config subsamples to 3% only because
    # the model blob is missing).
    pct_f, pcs_f, R_true_f, t_true_f = _known_transform_pair(
        cloud, len(cloud), 10000, seed=9)

    def check_f(model, R, t):
        return (np.abs(R - R_true_f).max() < 5e-3
                and np.abs(t - t_true_f).max() < 5e-3
                * np.abs(t_true_f).max())

    lines.append(_run_workload(
        "skull_full_resolution_98k", pct_f, pcs_f, CPU_CLASS_SECONDS,
        engine=EngineConfig(icp_multi_start=False),
        mse_threshold=1e-3, check=check_f))


def bench_dragon(lines):
    if not (os.path.exists(DRAGON_T) and os.path.exists(DRAGON_S)):
        _log("dragon data missing; skipped")
        return
    from fgoicp.config import EngineConfig
    from fgoicp.io import load_cloud

    pct = load_cloud(DRAGON_T, 0.1, seed=0)
    pcs = load_cloud(DRAGON_S, 0.05, seed=1)

    def check(model, R, t):
        # Two real scans, no ground truth: converged = the trimmed gap
        # closed below the threshold (the engine's own certificate).
        return model.mse <= 1e-3 * 1.0001 or model.best_sse <= \
            model.sse_threshold * 1.0001

    lines.append(_run_workload(
        "dragon_trimmed", pct, pcs, CPU_CLASS_SECONDS,
        mse_threshold=1e-3, trim_fraction=0.3, check=check))
    lines.append(_run_workload(
        "dragon_trimmed_device_outer", pct, pcs, CPU_CLASS_SECONDS,
        engine=EngineConfig(outer_mode="device"),
        mse_threshold=1e-3, trim_fraction=0.3, check=check))


def bench_serving(lines):
    """Throughput serving mode (models/serving.py): register a batch of
    32 randomly-transformed skull scans against one target in batched
    device calls.  The metric is PAIRS PER SECOND (steady state); the
    reference's unit of work is one pair per process run, so vs_baseline
    compares against the same pinned 30 s CPU-class per-pair wall."""
    if not os.path.exists(SKULL):
        _log("skull data missing; serving bench skipped")
        return
    from fgoicp.io import load_cloud
    from fgoicp.models import serving

    cloud = load_cloud(SKULL, 1.0, seed=0)
    rng = np.random.default_rng(11)
    ti = rng.choice(len(cloud), size=6000, replace=False)
    pct = cloud[ti]
    span = float(np.ptp(cloud, axis=0).max())
    b, ns = 32, 8000
    sources, Rs, ts = [], [], []
    for i in range(b):
        si = rng.choice(len(cloud), size=ns, replace=False)
        # Uniform random rotation via QR
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        R = (q * np.sign(np.diag(q))[None, :]).astype(np.float32)
        if np.linalg.det(R) < 0:
            R[:, 0] *= -1
        t = rng.uniform(-0.25, 0.25, size=3).astype(np.float32) * span
        sources.append((cloud[si] - t) @ R)
        Rs.append(R)
        ts.append(t)
    sources = np.stack(sources)

    srv = serving.RegistrationService(pct, mse_threshold=1e-3)
    wall = None
    for i in range(2):
        t0 = time.time()
        results = srv.register(sources)
        wall = time.time() - t0
        tag = "cold" if i == 0 else "steady"
        n_cert = sum(r.certified for r in results)
        n_fb = sum(r.fallback_used for r in results)
        _log(f"serving {tag}: {wall:.3f}s for {b} pairs "
             f"({b / wall:.1f} pairs/s), {n_cert} certified, "
             f"{n_fb} BnB fallbacks")
    ok = all(r.certified for r in results)
    for r, R_true, t_true in zip(results, Rs, ts):
        ok = ok and (np.abs(r.R - R_true).max() < 5e-3
                     and np.abs(r.t - t_true).max()
                     < 5e-3 * max(np.abs(t_true).max(), 1e-9))
    if not ok:
        _log("serving: CHECK FAILED (not all pairs certified+recovered)")
    lines.append({
        "metric": "serving_throughput_32pairs",
        "value": round(b / wall, 2),
        "unit": "pairs/s",
        "vs_baseline": round((b / wall) * CPU_CLASS_SECONDS, 2),
        "converged": bool(ok),
    })

    # Fallback-heavy regime (the line above certifies every pair by
    # seeding, so it never takes the fallback): half-space partial views at random poses — seeding cannot certify
    # every pair, and the uncertified ones exercise the batched-seeding
    # -> seed-handoff -> shared-coreset BnB fallback.  mse 3.5e-4 (not
    # the easy 1e-3): the partial views are full-overlap SUBSETS of the
    # target cloud, so true poses score 0.9-2.9e-4 (the 6000-subsample
    # NN floor) while wrong seeding basins sit at >=4.1e-4 — a loose
    # 1e-3 threshold let wrong poses CERTIFY (measured: 3 of 8 pairs,
    # |dR| up to 0.44), trimming a full-overlap view displaced the
    # trimmed optimum off the true pose, and 1e-4 sits BELOW the floor
    # so every fallback exhausts without certifying.  At 3.5e-4 every
    # certificate is a true pose and the wrong-basin pairs must take
    # the fallback (measured: 2 of 8).
    b2 = 8
    mu = cloud.mean(axis=0)
    sources2, Rs2, ts2 = [], [], []
    rng2 = np.random.default_rng(23)
    for i in range(b2):
        nrm = rng2.normal(size=3)
        nrm /= np.linalg.norm(nrm)
        part = cloud[(cloud - mu) @ nrm > 0]
        si = rng2.choice(len(part), size=min(6000, len(part)),
                         replace=False)
        q, _ = np.linalg.qr(rng2.normal(size=(3, 3)))
        R = (q * np.sign(np.diag(q))[None, :]).astype(np.float32)
        if np.linalg.det(R) < 0:
            R[:, 0] *= -1
        t = rng2.uniform(-0.25, 0.25, size=3).astype(np.float32) * span
        sources2.append((part[si] - t) @ R)
        Rs2.append(R)
        ts2.append(t)
    srv2 = serving.RegistrationService(pct, mse_threshold=3.5e-4)
    for i in range(2):
        t0 = time.time()
        # register() accepts the (possibly ragged) sequence directly —
        # np.stack would crash on unequal partial-view sizes before any
        # benching if a half-space cut ever shrinks below the draw.
        results2 = srv2.register(sources2)
        wall2 = time.time() - t0
        n_fb2 = sum(r.fallback_used for r in results2)
        _log(f"serving_fallback {'cold' if i == 0 else 'steady'}: "
             f"{wall2:.3f}s for {b2} partial-view pairs "
             f"({b2 / wall2:.2f} pairs/s), {n_fb2} BnB fallbacks")
    ok2 = n_fb2 > 0  # the regime must actually exercise the fallback
    for r, R_true, t_true in zip(results2, Rs2, ts2):
        # t tolerance is relative to the CLOUD SPAN, not |t_true|: the
        # subsampled-target NN floor displaces the optimum by ~0.1 on a
        # ~230-unit skull regardless of how small the true shift was.
        ok2 = ok2 and (np.abs(r.R - R_true).max() < 5e-3
                       and np.abs(r.t - t_true).max() < 2e-3 * span)
    if not ok2:
        _log("serving_fallback: CHECK FAILED (need fallbacks>0 and all "
             "pairs recovered)")
    lines.append({
        "metric": "serving_fallback_heavy_8pairs",
        "value": round(b2 / wall2, 2),
        "unit": "pairs/s",
        "vs_baseline": round((b2 / wall2) * CPU_CLASS_SECONDS, 2),
        "converged": bool(ok2),
        "fallbacks": int(n_fb2),
    })


def bench_bunny(lines):
    from fgoicp.config import EngineConfig
    from fgoicp.io import load_cloud
    if os.path.exists(BUNNY_TARGET) and os.path.exists(BUNNY_SOURCE):
        pct = load_cloud(BUNNY_TARGET, 0.5, seed=0)
        pcs = load_cloud(BUNNY_SOURCE, 0.1, seed=1)
    else:
        _log("reference data missing; synthetic surface workload")
        pct, pcs = _synthetic_pair()

    def check(model, R, t):
        return model.mse <= 1e-3

    # Search-throughput variant: multi-start seeding off, so the nested
    # BnB must do the work (the default engine's 15-start seeding lands
    # the global basin and reduces the run to ICP + a gap check —
    # legitimate, but it benchmarks seeding, not the search).
    lines.append(_run_workload(
        "bunny_bnb_search", pct, pcs, CPU_CLASS_SECONDS,
        engine=EngineConfig(icp_multi_start=False),
        mse_threshold=1e-3, check=check))
    # Same search with the outer SO(3) loop ON DEVICE (one jitted call
    # for the whole nested BnB, ops/so3_frontier.py) — amortizes the
    # per-outer-step dispatch cost.
    lines.append(_run_workload(
        "bunny_bnb_search_device_outer", pct, pcs, CPU_CLASS_SECONDS,
        engine=EngineConfig(icp_multi_start=False, outer_mode="device"),
        mse_threshold=1e-3, check=check))
    # Production-resolution LUT operating point:
    # the reference's shipped bunny config runs its distance LUT at
    # resolution 0.002 over the normalized target — a ~10^9-cell grid
    # (/root/reference/test/bunny.toml:18, registration.cu:186-198).
    # bfloat16 storage (1.35 GB; default — the relative quantization
    # slack costs a few extra nodes) + the chunked EDT builder keep the
    # build inside device memory; the asymmetric conservative slack
    # keeps the certificate valid.
    # Construction time (= field build) is logged separately above.
    if os.environ.get("FGOICP_BENCH_NO_LUT") != "1":
        lines.append(_run_workload(
            "bunny_lut_res0.002", pct, pcs, CPU_CLASS_SECONDS,
            engine=EngineConfig(icp_multi_start=False),
            mse_threshold=1e-3, check=check, bound_backend="lut",
            lut_resolution=0.002))
    # The CLASSIC Go-ICP benchmark: two real Stanford turntable scans,
    # 45-degree nominal offset, true calibrated rotation ~34 degrees
    # about the turntable (y) axis — genuine partial overlap, trimmed
    # registration, no synthetic transform anywhere.  The check asserts
    # the recovered rotation matches the known scanner geometry.
    b000 = f"{DATA}/bunny/bun000.ply"
    b045 = f"{DATA}/bunny/bun045.ply"
    if os.path.exists(b000) and os.path.exists(b045):
        s_t = load_cloud(b000, 0.5, seed=0)
        s_s = load_cloud(b045, 0.25, seed=1)

        def check_scan(model, R, t):
            ang = np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2,
                                               -1.0, 1.0)))
            axis = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                             R[1, 0] - R[0, 1]])
            axis /= (np.linalg.norm(axis) + 1e-12)
            return (model.mse <= 1e-4 * 1.0001 and 30.0 <= ang <= 38.0
                    and abs(axis[1]) >= 0.98)

        lines.append(_run_workload(
            "bunny_scans_000_045_trimmed", s_t, s_s, CPU_CLASS_SECONDS,
            mse_threshold=1e-4, trim_fraction=0.3, check=check_scan))
        # Same honest trimmed search with the whole nested BnB on device
        # (one jitted call per registration) — the dispatch-amortization
        # win applies to the hardest real-scan workload too.
        lines.append(_run_workload(
            "bunny_scans_device_outer", s_t, s_s, CPU_CLASS_SECONDS,
            engine=EngineConfig(outer_mode="device"),
            mse_threshold=1e-4, trim_fraction=0.3, check=check_scan))
    # HARD scan pairs: the classic Go-ICP
    # evaluation regime — turntable scans ~90 degrees apart and a
    # partial view with low overlap, where the 15-start seeding does
    # not certify and the trimmed BnB does the work.  Ground truth is
    # the published Stanford registration geometry (the .conf is not in
    # the mount, but the scanner geometry is public): bun090 is ~90.2
    # degrees about -y; chin is ~58.6 degrees about ~(-0.90, 0.43, 0.01)
    # with a real translation.
    b090 = f"{DATA}/bunny/bun090.ply"
    chin = f"{DATA}/bunny/chin.ply"
    if os.path.exists(b000) and os.path.exists(b090):
        s_t = load_cloud(b000, 0.5, seed=0)
        s_s = load_cloud(b090, 0.25, seed=1)

        def check_090(model, R, t):
            ang = np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2,
                                               -1.0, 1.0)))
            axis = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                             R[1, 0] - R[0, 1]])
            axis /= (np.linalg.norm(axis) + 1e-12)
            return (model.best_sse <= model.sse_threshold * 1.0001
                    and 84.0 <= ang <= 96.0 and abs(axis[1]) >= 0.98)

        lines.append(_run_workload(
            "bunny_scans_000_090_trimmed", s_t, s_s, CPU_CLASS_SECONDS,
            engine=EngineConfig(outer_mode="device"),
            mse_threshold=1e-4, trim_fraction=0.5, check=check_090))
    if os.path.exists(b000) and os.path.exists(chin):
        s_t = load_cloud(b000, 0.5, seed=0)
        s_s = load_cloud(chin, 0.25, seed=1)

        def check_chin(model, R, t):
            ang = np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2,
                                               -1.0, 1.0)))
            axis = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                             R[1, 0] - R[0, 1]])
            axis /= (np.linalg.norm(axis) + 1e-12)
            a_true = np.array([-0.900, 0.435, 0.014])
            return (model.best_sse <= model.sse_threshold * 1.0001
                    and 53.0 <= ang <= 64.0
                    and abs(float(axis @ a_true)) >= 0.95)

        lines.append(_run_workload(
            "bunny_chin_partial_trimmed", s_t, s_s, CPU_CLASS_SECONDS,
            engine=EngineConfig(outer_mode="device"),
            mse_threshold=1e-4, trim_fraction=0.5, check=check_chin))
    lines.append(_run_workload(
        "bunny_time_to_global_optimum", pct, pcs, CPU_CLASS_SECONDS,
        mse_threshold=1e-3, check=check))


def main():
    lines = []
    only = sys.argv[1] if len(sys.argv) > 1 else ""
    gate_ok = _kernel_gate()
    if only in ("", "skull"):
        bench_skull(lines)
    if only in ("", "dragon"):
        bench_dragon(lines)
    if only in ("", "serving"):
        bench_serving(lines)
    if only in ("", "bunny"):
        bench_bunny(lines)  # headline: must stay the LAST printed line
    for line in lines:
        if not gate_ok:
            line["gate_failed"] = True
        print(json.dumps(line), flush=True)
    if not gate_ok:
        sys.exit(1)  # a red kernel gate must never ship a green bench


if __name__ == "__main__":
    main()
