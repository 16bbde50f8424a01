"""Batched multi-pair registration: the production serving mode.

The reference registers exactly one cloud pair per process run
(/root/reference/src/main.cpp:41-53).  Production deployments localize
MANY scans against one known model (a map, a CAD part, an anatomy
atlas), where per-pair process launches waste the accelerator: each
pair's multi-start ICP uses a fraction of the chip, and the fixed
per-call dispatch cost dominates.

`RegistrationService` is built once over the shared target and
registers a whole batch of source clouds per call:

  1. **Batched seeding** — all B pairs x S multi-start rotations run as
     one lane-batched ICP (models/icp.py with per-lane sources), i.e.
     ONE device call for the entire batch regardless of B.  ICP lanes
     iterate against a shared proxy coreset of the target and the final
     poses are re-scored exactly on the full target (the engine's
     round-2 lever; the incumbent stays a true achievable SSE).
  2. **Certified gap check** — a pair whose normalized SSE falls below
     ns * mse_threshold satisfies the reference's own global-optimality
     termination rule at the root (best_sse - lb_root <= sse_threshold
     with lb_root = 0, fgoicp.cpp:44-47): the pose is certified within
     mse_threshold of the global optimum, by the same certificate a
     full BnB run would exit with immediately.
  3. **BnB fallback** — pairs the gap check leaves open run the full
     nested branch-and-bound (models/goicp.py) individually, inheriting
     the batch's seeding pose (seed handoff) and ONE shared FPS coreset
     of the target; if the handed-off seed does not certify, GoICP's
     cascaded seeding widens back to the full multi-start set before
     the BnB does any work.

Scaling: pairs are embarrassingly parallel — with a mesh, the batch
axis shards over the `cubes` mesh axis via shard_map (each device seeds
its slice of the batch; no collectives).

Frame conventions: seeding runs on CENTERED clouds without the
reference's source-max rescaling (ICP is scale-free; only the BnB's
translation domain needs the unit cube).  The certificate threshold is
converted instead: normalized SSE = scale^2 * SSE_centered with
scale = 1/max|centered source| (distances scale linearly, SSE
quadratically), so the check is bit-equivalent to the engine's
normalized-frame rule.  Returned poses are in the ORIGINAL world frame.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EngineConfig
from ..ops import coreset as coreset_ops
from ..ops import geometry as geo
from ..utils import logging as log
from . import icp as icp_model


@dataclasses.dataclass
class PairResult:
    """Registration result for one source cloud (world frame)."""
    R: np.ndarray            # [3, 3]
    t: np.ndarray            # [3]
    sse: float               # normalized-frame SSE (engine units)
    mse: float               # sse / ns (comparable to GoICP.mse)
    certified: bool          # optimality gap <= ns * mse_threshold
    fallback_used: bool      # pair needed the full BnB


@dataclasses.dataclass
class ServiceStats:
    pairs: int = 0
    certified_by_seeding: int = 0
    fallbacks: int = 0
    seed_seconds: float = 0.0
    fallback_seconds: float = 0.0


def start_rotations(multi_start: bool = True) -> np.ndarray:
    """[S, 3, 3] ICP seed rotations: identity (+ the engine's 14-start
    octant/face-center set) — delegates to the ONE shared builder
    (geometry.multi_start_rotations) so the serving sweep and the
    engine's cascade always use the same start set."""
    if not multi_start:
        return np.eye(3, dtype=np.float32)[None]
    return geo.multi_start_rotations()


@functools.partial(jax.jit, static_argnames=("trim_keep", "max_iter",
                                             "rescore"))
def _seed_pairs(pct_c, icp_target, sources, starts_R, convergence,
                convergence_final, seed_idx=None, trim_keep=None,
                max_iter: int = 100, rescore: bool = True,
                point_weights=None):
    """One device call: multi-start ICP seeding for a whole pair batch.

    Mirrors the single-pair engine's pipeline phases that precede a
    trivially-closing BnB (fgoicp.cpp:10-30): coarse multi-start seeding
    ICP (eps=convergence) over all B*S lanes against the proxy target,
    exact full-target re-score to pick each pair's best start, then the
    fine final polish (eps=convergence_final) on the B winning poses
    against the full target — whose carried SSE is already exact.

    pct_c: [nt, 3] centered target; icp_target: ICP iteration target
    (proxy coreset or pct_c); sources: [B, ns, 3] raw source clouds;
    starts_R: [S, 3, 3] seed rotations.
    Returns per-pair (sse_centered [B], R [B,3,3], t [B,3], scale [B],
    mu_s [B,3]) — sse in the centered (unscaled) frame; scale converts
    it to the engine's normalized frame (module docstring).
    """
    sources = jnp.asarray(sources, jnp.float32)
    b, ns, _ = sources.shape
    s_cnt = starts_R.shape[0]
    if point_weights is None:
        mu_s = jnp.mean(sources, axis=1)                   # [B, 3]
        src_c = sources - mu_s[:, None, :]
        scale = 1.0 / jnp.max(jnp.abs(src_c), axis=(1, 2))  # [B]
        w = None
    else:
        # Ragged batch: padding lanes carry weight 0 (they repeat a real
        # point, so they never perturb the max-extent either way — but
        # the mean and the certificate MUST ignore them).
        w = jnp.asarray(point_weights, jnp.float32)        # [B, ns]
        wn = w[..., None]
        mu_s = (jnp.sum(sources * wn, axis=1)
                / jnp.maximum(jnp.sum(wn, axis=1), 1e-12))
        src_c = sources - mu_s[:, None, :]
        scale = 1.0 / jnp.max(
            jnp.where(wn > 0, jnp.abs(src_c), 0.0), axis=(1, 2))

    # Seeding iterates on a SOURCE subsample (seed_idx) as well as the
    # proxy target: the B*S-lane phase only has to find each pair's
    # basin — the exact rescore, the full-source polish, and the
    # certificate all run on the full clouds, so the subsample can only
    # affect WHICH start wins, never the validity of the result.
    if seed_idx is None:
        src_seed, w_seed = src_c, w
    elif jnp.asarray(seed_idx).ndim == 1:
        src_seed = src_c[:, seed_idx]
        w_seed = None if w is None else w[:, seed_idx]
    else:
        # [B, S] per-pair indices: ragged batches must sample each
        # pair's REAL rows — a shared subsample drawn from the padded
        # range seeds small clouds on mostly zero-weight padding (and
        # can draw an all-padding subsample: zero total weight => NaN
        # Procrustes poses).
        idx = jnp.asarray(seed_idx)
        src_seed = jnp.take_along_axis(src_c, idx[:, :, None], axis=1)
        w_seed = None if w is None else jnp.take_along_axis(w, idx, axis=1)
    seed_trim = trim_keep
    if trim_keep is not None and seed_idx is not None:
        seed_trim = max(1, int(round(src_seed.shape[1] * trim_keep / ns)))
    R0 = jnp.tile(jnp.asarray(starts_R, jnp.float32), (b, 1, 1))
    t0 = jnp.zeros((b * s_cnt, 3), jnp.float32)
    seed_lanes = jnp.repeat(src_seed, s_cnt, axis=0)       # [B*S, k, 3]
    w_lanes = None if w_seed is None else jnp.repeat(w_seed, s_cnt, axis=0)
    sse_icp, R_l, t_l = icp_model.icp_batched(
        icp_target, seed_lanes, R0, t0, max_iter=max_iter,
        convergence_threshold=convergence, trim_keep=seed_trim,
        point_weights=w_lanes)
    if rescore or seed_idx is not None or w is not None:
        # Exact full-cloud SSE ranks the starts (proxy- or
        # subsample-iterated SSEs are biased).
        pcs_lanes = jnp.repeat(src_c, s_cnt, axis=0)
        sse_l = icp_model.exact_sse_batched(
            pct_c, pcs_lanes, R_l, t_l, trim_keep=trim_keep,
            point_weights=(None if w is None
                           else jnp.repeat(w, s_cnt, axis=0)))
    else:
        sse_l = sse_icp  # iterated on the full clouds: already exact
    sse_b = sse_l.reshape(b, s_cnt)
    k = jnp.argmin(sse_b, axis=1)                          # [B]
    lane = jnp.arange(b) * s_cnt + k
    # Final polish (fgoicp.cpp:22-23) on the winning pose per pair.
    sse_p, R_p, t_p = icp_model.icp_batched(
        pct_c, src_c, R_l[lane], t_l[lane], max_iter=max_iter,
        convergence_threshold=convergence_final, trim_keep=trim_keep,
        point_weights=w)
    # ICP returns the better of its last two iterates, but "better" is
    # judged on its own target; guard against a polish that worsened the
    # exact objective (cannot happen when it iterates on pct_c, but
    # costs one select).
    better = sse_p < sse_b[jnp.arange(b), k]
    sse = jnp.where(better, sse_p, sse_b[jnp.arange(b), k])
    R_out = jnp.where(better[:, None, None], R_p, R_l[lane])
    t_out = jnp.where(better[:, None], t_p, t_l[lane])
    return sse, R_out, t_out, scale, mu_s


class RegistrationService:
    """Batched registration of many source clouds against one target.

    Usage::

        srv = RegistrationService(model_cloud, mse_threshold=1e-3)
        results = srv.register(np.stack(scans))   # [B, ns, 3]
        for r in results:
            r.R, r.t, r.certified, ...

    The target-side structures (centered cloud, proxy coreset) build
    once; `register` batches arbitrarily many calls.  Pass `mesh` (axes
    from parallel.sharding) to shard the pair batch over the `cubes`
    mesh axis.
    """

    def __init__(self, target, mse_threshold: float = 1e-3,
                 engine: Optional[EngineConfig] = None,
                 proxy_size: int = 4096, trim_fraction: float = 0.0,
                 seed_subsample: int = 2048, mesh=None,
                 fallback_proxy_size: Optional[int] = None):
        self.engine = engine or EngineConfig()
        target = np.asarray(target, np.float32)
        if target.ndim != 2 or target.shape[1] != 3:
            raise ValueError(f"target cloud must be [N, 3], got {target.shape}")
        if not np.all(np.isfinite(target)):
            raise ValueError("target cloud contains NaN/inf values")
        self.pct = target
        self.nt = len(target)
        self.mse_threshold = float(mse_threshold)
        self.trim_fraction = float(trim_fraction)
        # proxy_size sizes the SEEDING ICP iteration target (bigger =
        # better correspondences for the B*S-lane sweep); the BnB
        # fallback's BOUND proxy defaults to the engine's proxy size
        # (1024, goicp.py rationale) and has its own knob.
        self.proxy_size = int(proxy_size)
        self.fallback_proxy_size = int(
            fallback_proxy_size if fallback_proxy_size is not None
            else 1024)
        # Seeding-phase source subsample size (0 = full source): the
        # B*S-lane seeding only has to FIND each pair's basin; rescore,
        # polish, and the certificate run on the full clouds
        # (_seed_pairs docstring), so this is a pure-cost knob.
        self.seed_subsample = int(seed_subsample)
        self.mesh = mesh
        self.mu_t = target.mean(axis=0)
        # Centered target + shared ICP iteration target (proxy coreset
        # when smaller) — device-resident, built once per service.
        self.pct_c = jnp.asarray(target - self.mu_t)
        if self.engine.icp_search_on_proxy and self.nt > proxy_size:
            self._icp_target = coreset_ops.build(
                self.pct_c, size=proxy_size, seed=self.engine.seed).points
            self._rescore = True
        else:
            self._icp_target = self.pct_c
            self._rescore = False
        self._starts = start_rotations(self.engine.icp_multi_start)
        self._fallback_proxy = None  # built on first fallback, shared
        self.stats = ServiceStats()

    # ------------------------------------------------------------------
    def _seed_call(self, sources, trim_keep, point_weights=None):
        """Dispatch the batched seeding — sharded over the mesh's cubes
        axis when one is configured (pairs are independent: shard_map
        with no collectives), single-call otherwise."""
        # Seeding runs at the BnB-trigger eps (0.005), NOT the engine's
        # coarse init eps (0.05): the per-pair winner is selected by
        # argmin over starts, and coarsely-converged SSEs rank basins
        # unreliably (measured: the 0.05-eps argmin picked a wrong-basin
        # start that a finer seed certifies directly).  A few extra
        # lockstep iterations are far cheaper than the BnB fallback each
        # wrong selection forces.
        args = (self.pct_c, self._icp_target,
                np.asarray(sources, np.float32), self._starts,
                np.float32(self.engine.icp_convergence_bnb),
                np.float32(self.engine.icp_convergence_final))
        ns = int(sources.shape[1] if hasattr(sources, "shape")
                 else len(sources[0]))
        seed_idx = None
        if 0 < self.seed_subsample < ns:
            rng = np.random.default_rng(self.engine.seed + 7)
            if point_weights is None:
                seed_idx = rng.permutation(ns)[
                    :self.seed_subsample].astype(np.int32)
            else:
                # Ragged: per-pair subsample over each pair's REAL rows
                # (the prefix — padding repeats row 0 with weight 0).
                # Pairs smaller than the subsample tile their rows:
                # uniform over-weighting cannot bias the seed, and the
                # exact rescore/polish run on the true weights.
                s_sub = self.seed_subsample
                rows = []
                for wrow in np.asarray(point_weights):
                    # register() builds BINARY prefix weights (real rows
                    # first, zero-weight padding after); count nonzeros
                    # rather than summing so any future soft weights
                    # still index only real rows.
                    n_real = max(1, int(np.count_nonzero(wrow)))
                    perm = rng.permutation(n_real)
                    reps = -(-s_sub // n_real)
                    rows.append(np.tile(perm, reps)[:s_sub])
                seed_idx = np.stack(rows).astype(np.int32)
        kw = dict(seed_idx=seed_idx, trim_keep=trim_keep,
                  max_iter=self.engine.icp_max_iter, rescore=self._rescore)
        if self.mesh is None:
            return jax.device_get(_seed_pairs(
                *args, point_weights=point_weights, **kw))
        from jax.sharding import PartitionSpec as P
        from ..parallel import sharding as psh
        n = self.mesh.shape[psh.CUBES_AXIS]
        b = len(sources)
        pad = (-b) % n
        if pad:
            src = np.concatenate(
                [args[2], np.repeat(args[2][:1], pad, axis=0)])
            args = args[:2] + (src,) + args[3:]
            if point_weights is not None:
                point_weights = np.concatenate(
                    [point_weights,
                     np.repeat(point_weights[:1], pad, axis=0)])
        if point_weights is None:
            shard = functools.partial(_seed_pairs, **kw)
            specs = (P(), P(), P(psh.CUBES_AXIS), P(), P(), P())
        elif isinstance(seed_idx, np.ndarray) and seed_idx.ndim == 2:
            # Per-pair (ragged) subsample rides the batch axis: a
            # closure constant would pair shard-local sources with the
            # GLOBAL index matrix.
            if pad:
                seed_idx = np.concatenate(
                    [seed_idx, np.repeat(seed_idx[:1], pad, axis=0)])
            kw2 = {k: v for k, v in kw.items() if k != "seed_idx"}
            shard = functools.partial(
                lambda *a, **k: _seed_pairs(
                    *a[:-2], point_weights=a[-2], seed_idx=a[-1], **k),
                **kw2)
            specs = (P(), P(), P(psh.CUBES_AXIS), P(), P(), P(),
                     P(psh.CUBES_AXIS), P(psh.CUBES_AXIS))
            args = args + (np.asarray(point_weights, np.float32),
                           seed_idx)
        else:
            shard = functools.partial(
                lambda *a, **k: _seed_pairs(
                    *a[:-1], point_weights=a[-1], **k), **kw)
            specs = (P(), P(), P(psh.CUBES_AXIS), P(), P(), P(),
                     P(psh.CUBES_AXIS))
            args = args + (np.asarray(point_weights, np.float32),)
        fn = jax.shard_map(
            shard, mesh=self.mesh, in_specs=specs,
            out_specs=P(psh.CUBES_AXIS), check_vma=False)
        out = jax.device_get(fn(*args))
        return tuple(a[:b] for a in out)

    def _fallback(self, source, trim_keep, seed_pose=None):
        """Full nested-BnB registration for one uncertified pair.

        Target-side structures are SHARED across fallbacks (one FPS
        coreset on the centered target, rescaled per pair — GoICP
        shared_proxy), and the pair's batched seeding pose is handed
        off (seed_pose = (R, t_centered, mu_s) from _seed_pairs) so the
        BnB starts from the incumbent the batch already found instead
        of redoing the 15-start sweep per pair."""
        from .goicp import GoICP
        if self._fallback_proxy is None:
            self._fallback_proxy = coreset_ops.build(
                self.pct_c, size=self.fallback_proxy_size,
                seed=self.engine.seed)
        seed_kw = {}
        if seed_pose is not None:
            R_s, t_s, mu_s = seed_pose
            # _seed_pairs centers the source by ITS mean; GoICP uses the
            # same centroid, so the centered-frame pose carries over.
            seed_kw["seed_pose_centered"] = (R_s, t_s)
        model = GoICP(
            self.pct, source, mse_threshold=self.mse_threshold,
            engine=self.engine, trim_fraction=self.trim_fraction,
            shared_proxy=self._fallback_proxy, **seed_kw)
        R, t = model.run()
        certified = (model.last_certified_gap is None
                     or model.last_certified_gap <= model.sse_threshold
                     + 1e-6 * model.sse_threshold)
        return PairResult(
            R=np.asarray(R), t=np.asarray(t), sse=float(model.best_sse),
            mse=float(model.mse), certified=bool(certified),
            fallback_used=True)

    def register(self, sources, fallback: bool = True):
        """Register a batch of source clouds; returns [B] PairResults.

        sources: [B, ns, 3] array, a sequence of equal-shape [ns, 3]
        clouds, or a RAGGED sequence of [ns_i, 3] clouds of differing
        sizes — ragged batches pad each cloud to the max size with
        zero-WEIGHT repeats of its first point (no point is ever
        discarded; the weights mask Procrustes, the SSE, and the
        certificate, and each pair certifies against its own
        ns_i * mse_threshold).  Ragged batches cannot combine with
        trim_fraction (per-pair trim counts would need a dynamic top-k).
        All pairs seed in one batched device call; pairs whose
        certificate stays open run the full BnB individually unless
        `fallback=False` (their results come back certified=False).
        """
        raw = [np.asarray(s, np.float32) for s in sources] \
            if not (isinstance(sources, np.ndarray) and sources.ndim == 3) \
            else None
        weights = None
        if raw is not None and len(raw) > 0 and raw[0].ndim == 2 \
                and len({r.shape[0] for r in raw}) > 1:
            # Ragged: pad with zero-weight repeats of the first point.
            for i, r in enumerate(raw):
                if r.ndim != 2 or r.shape[1] != 3:
                    raise ValueError(
                        f"source {i} must be [ns, 3], got {r.shape}")
            if self.trim_fraction > 0.0:
                raise ValueError(
                    "ragged batches cannot combine with trim_fraction")
            ns_max = max(r.shape[0] for r in raw)
            b = len(raw)
            sources = np.empty((b, ns_max, 3), np.float32)
            weights = np.zeros((b, ns_max), np.float32)
            for i, r in enumerate(raw):
                sources[i, :len(r)] = r
                sources[i, len(r):] = r[0]
                weights[i, :len(r)] = 1.0
            ns_real = np.asarray([len(r) for r in raw], np.float32)
        else:
            sources = np.asarray(sources, np.float32)
            if sources.ndim == 2:
                sources = sources[None]
            if sources.ndim != 3 or sources.shape[-1] != 3:
                raise ValueError(
                    f"sources must be [B, ns, 3] or a ragged sequence of "
                    f"[ns_i, 3] clouds, got {sources.shape}")
            ns_real = np.full((sources.shape[0],), sources.shape[1],
                              np.float32)
        if not np.all(np.isfinite(sources)):
            raise ValueError("source batch contains NaN/inf values")
        b, ns = sources.shape[:2]
        trim_keep = (None if self.trim_fraction <= 0.0 else
                     max(1, int(round(ns * (1.0 - self.trim_fraction)))))
        # Per-pair certificate threshold: the engine's rule is
        # SSE <= ns * mse (fgoicp.hpp:23) — for trimmed runs TOO, so
        # the seeding path certifies exactly the SSE its own GoICP
        # fallback would (a trim_keep*mse rule here made borderline
        # trimmed pairs pay a full BnB fallback that then certified the
        # same pose under the engine's looser ns*mse rule).
        thr = ns_real * self.mse_threshold

        t0 = time.time()
        sse_c, R_b, t_b, scale, mu_s = self._seed_call(
            sources, trim_keep, weights)
        self.stats.seed_seconds += time.time() - t0

        # Normalized-frame SSE (module docstring) drives the reference's
        # root-gap certificate: sse_norm <= ns * mse_threshold.
        sse_norm = sse_c * scale * scale
        certified = sse_norm <= thr
        results: list[Optional[PairResult]] = [None] * b
        t1 = time.time()
        for i in range(b):
            if certified[i] or not fallback:
                # World frame: R (s - mu_s) + t ~ target - mu_t
                # => t_world = t - R mu_s + mu_t.
                t_world = t_b[i] - R_b[i] @ mu_s[i] + self.mu_t
                results[i] = PairResult(
                    R=R_b[i], t=t_world, sse=float(sse_norm[i]),
                    mse=float(sse_norm[i] / ns_real[i]),
                    certified=bool(certified[i]), fallback_used=False)
            else:
                src_i = raw[i] if raw is not None else sources[i]
                results[i] = self._fallback(
                    src_i, trim_keep,
                    seed_pose=(R_b[i], t_b[i], mu_s[i]))
        self.stats.fallback_seconds += time.time() - t1
        self.stats.pairs += b
        self.stats.certified_by_seeding += int(np.sum(certified))
        self.stats.fallbacks += int(b - np.sum(certified)) if fallback else 0
        n_fb = sum(r.fallback_used for r in results)
        log.debug(f"Serving batch: {b} pairs, "
                  f"{int(np.sum(certified))} certified by seeding, "
                  f"{n_fb} BnB fallbacks")
        return results


def register_pairs(target, sources, mse_threshold: float = 1e-3,
                   **kw):
    """One-shot convenience wrapper around RegistrationService."""
    srv = RegistrationService(target, mse_threshold=mse_threshold, **kw)
    return srv.register(sources)
