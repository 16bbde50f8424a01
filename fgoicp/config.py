"""TOML run-configuration with schema parity to the reference.

The reference parses `[io] target/source/output/visualization` and
`[params] trim/target_subsample/source_subsample/lut_resolution/mse_threshold`
with clamping rules (/root/reference/src/utilities.hpp:18-107).  This module
keeps that schema bit-for-bit (same keys, same defaults, same clamps) and adds
an optional `[engine]` section exposing every knob the reference hard-codes
(ICP iteration counts and thresholds, span cutoffs, batch sizes — see
/root/reference/fgoicp/fgoicp.cpp:12,22,53,76,122,155) plus this engine's
own settings (frontier capacity, seed, LUT dtype/builder, mesh axes).

Unlike the reference, subsampling here is seeded and deterministic (the
reference uses std::random_device, utilities.hpp:149-151).
"""

from __future__ import annotations

import dataclasses
import math
import tomllib
from typing import Optional

from .utils import logging as log


def _clamp(x: float, lo: float, hi: float) -> float:
    return min(max(x, lo), hi)


def _coerce_engine_value(name: str, value, default):
    """Type-checked coercion for an [engine] TOML value.

    TOML already delivers typed values; this only permits the safe
    widenings (int -> float, and exact-int floats for int fields) and
    rejects everything else — `frontier_mode = 3` must be an error, not
    the string "3"."""
    want = type(default)
    if want is bool:
        if isinstance(value, bool):
            return value
    elif want is int:
        if isinstance(value, bool):
            pass  # bool is an int subclass; reject for int fields
        elif isinstance(value, int):
            return value
        elif isinstance(value, float) and value == int(value):
            return int(value)
    elif want is float:
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            return float(value)
    elif want is str:
        if isinstance(value, str):
            return value
    raise ValueError(
        f"[engine] {name} expects {want.__name__}, got "
        f"{type(value).__name__} ({value!r})")


@dataclasses.dataclass
class IOConfig:
    target: str = ""
    source: str = ""
    output: str = ""          # result toml path ("" = skip)
    visualization: str = ""   # transformed-source ply path ("" = skip)


@dataclasses.dataclass
class Params:
    # Reference [params] schema (utilities.hpp:29-36,94-104).
    trim: bool = False
    target_subsample: float = 1.0
    source_subsample: float = 1.0
    lut_resolution: float = 0.005
    mse_threshold: float = 1e-3
    # Trimming fraction actually used when trim=True.  The reference parses
    # `trim` but never implements it (SURVEY: utilities.hpp:94 only); here it
    # is functional: the SSE keeps only the best (1-trim_fraction) residuals.
    trim_fraction: float = 0.1


@dataclasses.dataclass
class EngineConfig:
    """Knobs the reference hard-codes, plus this engine's settings."""

    seed: int = 0
    # BnB geometry (fgoicp.cpp:36,53,113,155).
    rotation_min_span: float = 0.05
    translation_min_span: float = 0.1
    # Inner-BnB batching: the reference pops <=32 nodes per step and runs one
    # CUDA stream per node (fgoicp.cpp:122, common.hpp:138-164).  Here a batch
    # is one lane-axis of a single jitted evaluation.
    translation_batch: int = 32
    # Number of rotation nodes popped from the outer queue per device step;
    # their (up to) 8 children each run inner BnB in lockstep on-device.
    # Deeper batches share the incumbent across more children per device
    # call (fewer node evaluations) and cut host round-trips.
    rotation_batch: int = 16
    # Fixed capacity of the per-group device translation frontier.
    frontier_capacity: int = 4096
    # Inner-BnB scheduling: 'pooled' = one global device frontier shared
    # by all rotation candidates (full lane utilization, default);
    # 'grouped' = per-group lockstep frontiers (the multi-device sharded
    # path currently uses this).
    frontier_mode: str = "pooled"
    # Outer SO(3) loop placement: 'host' (default) keeps the cheap
    # sequential heap on host (unbounded frontier — cannot overflow);
    # 'device' runs the ENTIRE
    # nested search (outer octree + inner pools + ICP refinements) in
    # one jitted while_loop (ops/so3_frontier.py) — one device call per
    # registration, amortizing the per-outer-step dispatch and readback
    # that dominate deep searches.
    outer_mode: str = "host"
    # Fixed capacity of the device SO(3) frontier (outer_mode='device');
    # overflow is certificate-safe (dropped-lb clamp) but slows search.
    so3_capacity: int = 16384
    pool_lanes: int = 1024        # nodes evaluated per pooled step
    pool_capacity: int = 32768    # pooled frontier capacity
    # Pooled frontier update strategy: "sort" = argsort the whole
    # [capacity + 8*lanes] concat each step; "merge" = keep the pool
    # sorted invariantly and binary-search-merge the 8*lanes children
    # in (dominance filtering moves to pop time; identical pop order,
    # pool_frontier._merge_sorted).  Both exact.  Its dependent
    # count-less passes serialize where one wide argsort vectorizes; on
    # the H100 the two are not measured yet.
    pool_update: str = "sort"
    # ICP (fgoicp.cpp:12,22,76).
    icp_max_iter: int = 100
    # Fixed lane width of batched ICP calls: triggered BnB candidates are
    # compacted into chunks of this width (typically 1-2 trigger per outer
    # step, so running the full child batch wastes >90% of the NN work).
    # 16 fits the 15-start multi-start seeding in one call.
    icp_width: int = 16
    icp_convergence_init: float = 0.05
    icp_convergence_bnb: float = 0.005
    icp_convergence_final: float = 0.0005
    # Cascaded seeding (models/goicp.py:_initial_icp).  Stage 1 sweeps
    # the 15 multi-starts at the reference's 5% cutoff
    # (icp_convergence_init, fgoicp.cpp:12).  If that does not already
    # certify (best sse > sse_threshold), the sweep WARM-RESTARTS at
    # icp_seed_fine_conv: a 5% relative-improvement cutoff quits
    # trimmed partial-overlap ICPs on their long sub-5% plateaus — on
    # the 90-degree bun000/bun090 pair the face-center start 0.2
    # degrees from the TRUE rotation stalled at 38x the achievable SSE
    # and would never rank for the polish stage.  If the fine sweep
    # still does not certify, the top icp_seed_polish_width lanes
    # re-descend as a FULL-CLOUD trimmed ICP at icp_seed_polish_conv:
    # the subsample/proxy search path stalls terminally on hard-pair
    # plateaus (measured: bun090 +y90 lane 2.91 at any max_iter) while
    # the full-cloud descent reaches the global basin (0.38 in <=300
    # iterations) — collapsing the whole hard-pair BnB to a gap check
    # that certifies the true optimum.  Certifying workloads exit after
    # stage 1 and pay nothing.
    icp_seed_fine_conv: float = 0.001
    icp_seed_polish: bool = True
    icp_seed_polish_conv: float = 1e-4
    icp_seed_polish_iters: int = 300
    icp_seed_polish_width: int = 4
    icp_trigger_factor: float = 1.8
    # Top the triggered set up to a full icp_width ICP batch with the
    # lowest-ub children (a batched call costs the same for 1 lane or
    # 16) — free basin-finding attempts that break the local-minimum
    # stall regime where a wrong-basin incumbent starves the 1.8x
    # trigger (measured 84 vs 6 outer steps on bunny).  Extra
    # refinement never weakens the certificate.
    icp_refine_best: bool = True
    # Seed the incumbent from identity + the 8 rotation-cube octant
    # centers in one batched ICP call (the reference seeds from identity
    # only); a stronger initial incumbent prunes the whole BnB.
    icp_multi_start: bool = True
    # Search-phase ICPs (initial seeding + BnB triggers) iterate against
    # the proxy coreset instead of the full target (~4x fewer NN targets
    # per iteration); the resulting pose is re-scored with one exact
    # full-target NN pass so the incumbent stays a true achievable SSE.
    # The final polish always uses the full target.
    icp_search_on_proxy: bool = True
    # Search-phase ICPs also ITERATE on a source subsample of this size
    # (0 = full source).  Seeding/refine lanes only need to FIND a basin:
    # the winning pose is re-scored with one exact full-cloud NN pass, so
    # the incumbent stays a true achievable SSE and the certificate is
    # untouched — the subsample can only change WHICH basin a lane lands,
    # same as the proxy-target lever above (serving.py proved the pattern
    # at 2048; applied to the engine in round 4).  The final polish
    # always runs the full source against the full target.
    icp_search_subsample: int = 2048
    # Bound math: when True, reproduce the reference's rotation-uncertainty
    # radius exactly (squared point norm, unclamped half-angle,
    # registration.cu:39-43); when False use the Go-ICP paper's correct form
    # (point norm, half-angle clamped to pi/2).
    ref_compat_gamma: bool = False
    # Distance field.
    # bfloat16 default: storage quantization folds into the certificate
    # as a RELATIVE per-lookup slack (+8 nodes of 17k on the production
    # bunny field) and halves the field's device-memory residency and
    # its gather bytes.
    lut_dtype: str = "bfloat16"     # float32 | bfloat16 | float16
    lut_builder: str = "auto"       # auto | brute | edt
    # LUT query form: "nearest" = 1 gather/query, "trilinear" = 8 (the
    # reference's texture filtering).  The 1-Lipschitz worst-case error
    # bound is sqrt(3)/2*res for both, so conservative certificates are
    # identical; "auto" = nearest when conservative (gathers are the
    # whole cost of a LUT query), trilinear in raw/ref modes.
    lut_lookup: str = "auto"        # auto | nearest | trilinear
    lut_max_dim: int = 2048         # hard error above (registration.cu:191)
    lut_warn_dim: int = 1024        # warn above (registration.cu:195)
    # Fold builder + interpolation + storage-quantization slack into the
    # LUT distance estimates so lb <= true SSE stays valid (default).
    # False reproduces raw lookups (tighter but unsound, like the ref).
    lut_conservative: bool = True
    # Reproduce the reference LUT exactly for parity debugging: d^2
    # texture, ceil(range/res) dims, half-texel-shifted trilinear lookup
    # (registration.cu:186-188,214-234,320-328).  Implies no slack.
    ref_compat_lut: bool = False
    # Hierarchical source bounds: when > 0 and the source has more points,
    # SEARCH-phase bound evaluation runs over this many weighted FPS
    # clusters (coreset.SourceClusters) instead of every source point —
    # O(K*P) instead of O(ns*P) per node, with the cluster radius folded
    # into both bounds so validity is preserved.  ICP and incumbent SSE
    # always use the full source.  Incompatible with trimming (disabled
    # automatically).  0 = off; -1 (default) = auto: off for ns <= 2048,
    # else K = clip(2^round(log2(ns/3)), 1024, 4096), with identical
    # optima.
    source_coreset: int = -1
    # Parallel layout.
    mesh_cubes: int = 1             # devices along the rotation-cube axis
    mesh_points: int = 1            # devices sharding the source-point axis
    # Multi-host protocol (parallel/distributed.py): outer steps each host
    # runs between incumbent all-gathers (staleness bound — a stale
    # incumbent only weakens pruning, never soundness), and the max nodes
    # a round's work-stealing transfer may move to idle hosts (0 = off).
    multihost_sync_every: int = 1
    multihost_steal_max: int = 8
    # Seconds before a multi-host allgather gives up and raises a clean
    # error with a checkpoint-recovery hint instead of hanging forever on
    # a dead peer (0 = block indefinitely, matching raw jax collectives).
    multihost_timeout_s: float = 0.0
    # Checkpoint/resume of BnB state ("" = disabled).
    checkpoint_path: str = ""
    checkpoint_every: int = 0       # outer steps between checkpoints
    # Search-state sanitizer (utils/sanitize.py): validate frontier
    # structure, lb <= ub bracketing, and incumbent faithfulness at
    # every outer step / device chunk boundary.  Debug mode — one extra
    # exact-SSE evaluation per checked point (CLI: --debug-checks).
    debug_checks: bool = False


@dataclasses.dataclass
class Config:
    io: IOConfig = dataclasses.field(default_factory=IOConfig)
    params: Params = dataclasses.field(default_factory=Params)
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)

    @classmethod
    def from_toml(cls, path: str) -> "Config":
        base = path.replace("\\", "/").rsplit("/", 1)[-1]
        log.info(f"Reading configurations from {base}")
        with open(path, "rb") as f:
            tbl = tomllib.load(f)
        cfg = cls.from_dict(tbl)
        log.info(str(cfg))
        return cfg

    @classmethod
    def from_dict(cls, tbl: dict) -> "Config":
        cfg = cls()
        io_s = tbl.get("io", {})
        cfg.io.target = io_s.get("target", "")
        cfg.io.source = io_s.get("source", "")
        cfg.io.output = io_s.get("output", "")
        cfg.io.visualization = io_s.get("visualization", "")

        p = tbl.get("params", {})
        cfg.params.trim = bool(p.get("trim", False))
        cfg.params.target_subsample = float(p.get("target_subsample", 1.0))
        cfg.params.source_subsample = float(p.get("source_subsample", 1.0))
        cfg.params.lut_resolution = float(p.get("lut_resolution", 0.005))
        cfg.params.mse_threshold = float(p.get("mse_threshold", 1e-3))
        cfg.params.trim_fraction = float(p.get("trim_fraction", 0.1))

        # Reference clamps (utilities.hpp:101-104): subsamples to [1e-5, 1],
        # source further to <=0.5, mse to >=1e-12.
        cfg.params.target_subsample = _clamp(cfg.params.target_subsample, 1e-5, 1.0)
        cfg.params.source_subsample = _clamp(cfg.params.source_subsample, 1e-5, 1.0)
        cfg.params.source_subsample = _clamp(cfg.params.source_subsample, 1e-5, 0.5)
        cfg.params.mse_threshold = _clamp(cfg.params.mse_threshold, 1e-12, math.inf)
        cfg.params.trim_fraction = _clamp(cfg.params.trim_fraction, 0.0, 0.9)

        e = tbl.get("engine", {})
        known = {f.name for f in dataclasses.fields(EngineConfig)}
        for key in e:
            if key not in known:
                raise ValueError(f"Unknown [engine] key: {key!r}")
        for f in dataclasses.fields(EngineConfig):
            if f.name in e:
                setattr(cfg.engine, f.name,
                        _coerce_engine_value(f.name, e[f.name],
                                             getattr(cfg.engine, f.name)))
        return cfg

    def __str__(self) -> str:
        # Mirrors the reference's Config printer (utilities.hpp:46-58).
        return (
            "Fast Go-ICP Configurations\n"
            "\tIO Configuration:\n"
            f"\t\tTarget: {self.io.target}\n"
            f"\t\tSource: {self.io.source}\n"
            "\tParameters:\n"
            f"\t\tTrim: {'true' if self.params.trim else 'false'}\n"
            f"\t\tTarget Subsample: {self.params.target_subsample}\n"
            f"\t\tSource Subsample: {self.params.source_subsample}\n"
            f"\t\tLUT Resolution: {self.params.lut_resolution}\n"
            f"\t\tMSE Threshold: {self.params.mse_threshold}"
        )
