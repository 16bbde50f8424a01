"""Go-ICP: globally-optimal registration via nested BnB over SE(3).

Pipeline parity with FastGoICP (/root/reference/fgoicp/fgoicp.{hpp,cpp}):
  1. normalize both clouds (center, source-max scale)        fgoicp.hpp:13-25
  2. initial ICP from identity (eps 0.05) seeds the incumbent fgoicp.cpp:12-14
  3. outer best-first BnB over the SO(3) quaternion cube      fgoicp.cpp:32-100
     - octree children, min half-span 0.05, SO(3) overlap tests
     - children overlapping-but-outside SO(3) re-queued with stale parent
       bounds (reference quirk, fgoicp.cpp:61-66 — reproduced)
     - per in-SO(3) child: inner R^3 BnB for the rotation upper bound
       (fix_rot) and lower bound, ICP refinement when
       ub < incumbent * 1.8 (fgoicp.cpp:69-96)
  4. final ICP polish (eps 0.0005) + translation de-normalization
     fgoicp.cpp:22-29

Design: the outer priority queue stays on host (cheap,
sequential by nature) but each outer step pops a BATCH of rotation nodes
and evaluates all their children's inner searches in ONE device call —
ub-pass and lb-pass groups share a pooled global frontier inside a
jitted while_loop (ops/pool_frontier.py; per-group lockstep mode in
ops/frontier.py), and triggered ICPs run as width-compacted batched ICP
(models/icp.py).  This replaces the reference's thousands of small kernel
launches over a 32-stream pool with a handful of large fused device steps
per outer iteration.  Optional extras beyond the reference: multi-start
incumbent seeding, hierarchical source-cluster bounds, checkpoint/resume,
and mesh sharding (parallel/).

Deviation from the reference's sequential semantics: within one outer
batch, all children see the incumbent from the start of the step (the
reference lets child k's search see child k-1's ICP improvement).  This
only weakens in-search pruning slightly; pruning decisions against the
final incumbent are identical.
"""

from __future__ import annotations

import dataclasses
import functools
import heapq
import itertools
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config, EngineConfig
from ..ops import bounds as bounds_ops
from ..ops import distance_field as df_ops
from ..ops import frontier as frontier_ops
from ..ops import geometry as geo
from ..ops import nn as nn_ops
from ..ops import pool_frontier
from ..parallel import bnb as pbnb
from ..parallel import sharding as psh
from ..utils import checkpoint as ckpt
from ..utils import logging as log
from . import icp as icp_model

BIG = 1e10  # reference M_INF (common.hpp:18)
NO_CLOSED_LEAF = 1e29  # _closed_leaf_lb sentinel: no terminal leaf closed


@dataclasses.dataclass
class GoICPStats:
    rotation_nodes: int = 0        # outer nodes expanded
    rotation_children: int = 0     # in-SO(3) children evaluated
    rotation_pruned: int = 0       # children discarded by lb >= best_sse
    translation_nodes: int = 0     # inner bound evaluations (ref: count)
    icp_runs: int = 0
    icp_triggered: int = 0         # children passing the 1.8x trigger
    outer_steps: int = 0
    inner_loop_steps: int = 0
    dropped_nodes: int = 0
    wall_seconds: float = 0.0

    @property
    def cubes_per_second(self):
        return self.translation_nodes / max(self.wall_seconds, 1e-9)


class GoICP:
    """Globally-optimal registration engine (flagship model).

    Equivalent public surface to icp::FastGoICP: construct with
    (target, source, lut_resolution, mse_threshold), call run(), read
    get_best_error / get_best_transform / get_last_transform
    (fgoicp.hpp:30-43).
    """

    def __init__(self, pct, pcs, lut_resolution: float = 0.005,
                 mse_threshold: float = 1e-3,
                 engine: Optional[EngineConfig] = None,
                 bound_backend: str = "proxy", proxy_size: int = 1024,
                 trim_fraction: float = 0.0, mesh=None,
                 seed_pose_centered=None, shared_proxy=None):
        # seed_pose_centered (R [3,3], t [3]) — a pose in the CENTERED
        # frame (R (pcs - mu_s) + t ~ pct - mu_t) from an external
        # seeding pass (the serving batch, models/serving.py); the
        # initial ICP starts from it (plus identity) instead of the
        # 15-start sweep, which the caller already ran.
        # shared_proxy: ProxyCoreset built ONCE on the CENTERED target,
        # rescaled here by this pair's normalization factor (FPS is
        # scale-covariant: same indices, eps scales linearly) — the
        # serving fallback path shares one build across pairs.
        # proxy_size=1024: per-node bound cost is linear in the proxy
        # while the covering-radius slack only adds ~10-20% node
        # expansions going 4096 -> 1024 (scripts/proxy_sweep.py sweeps
        # it).
        self.engine = engine or EngineConfig()
        e = self.engine
        pct = np.asarray(pct, np.float32)
        pcs = np.asarray(pcs, np.float32)
        for name, pc in (("target", pct), ("source", pcs)):
            if pc.ndim != 2 or pc.shape[1] != 3:
                raise ValueError(
                    f"{name} cloud must be [N, 3], got {pc.shape}")
            if pc.shape[0] < 3:
                raise ValueError(
                    f"{name} cloud needs at least 3 points, got {pc.shape[0]}")
            if not np.all(np.isfinite(pc)):
                raise ValueError(f"{name} cloud contains NaN/inf values")
        if self.engine.outer_mode not in ("host", "device"):
            raise ValueError(
                f"Unknown outer_mode: {self.engine.outer_mode!r}")
        self.ns, self.nt = len(pcs), len(pct)
        self.norm = geo.Normalization(pct, pcs)
        self.pct = self.norm.pct   # normalized target, on device
        self.pcs = self.norm.pcs   # normalized source, on device
        self.mse_threshold = mse_threshold
        self.sse_threshold = float(self.ns * mse_threshold)  # fgoicp.hpp:23
        self.trim_keep = (None if trim_fraction <= 0.0 else
                          max(1, int(round(self.ns * (1.0 - trim_fraction)))))

        if bound_backend == "lut":
            lut_dtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
                         "float16": jnp.float16}[e.lut_dtype]
            builder = "ref" if e.ref_compat_lut else e.lut_builder
            field = df_ops.build(
                self.pct, self.norm.target_bounds, lut_resolution,
                builder=builder, dtype=lut_dtype, max_dim=e.lut_max_dim,
                warn_dim=e.lut_warn_dim)
            # conservative folds the field+interpolation slack into the
            # distance estimates so lb <= true SSE holds for EDT-built and
            # narrow-dtype fields too; ref-compat mode deliberately drops
            # the guarantee (it reproduces the reference's raw texture
            # lookup, registration.cu:320-328).
            self.backend = bounds_ops.make_backend(
                self.pct, kind="lut", field=field,
                conservative=e.lut_conservative,
                ref_compat=e.ref_compat_lut, lookup=e.lut_lookup)
        elif shared_proxy is not None and bound_backend == "proxy":
            # Rescale the caller's centered-target coreset into this
            # pair's normalized frame (uniform scaling: identical FPS
            # selection, covering radius scales linearly).
            from ..ops import coreset as coreset_ops
            cs = coreset_ops.ProxyCoreset(
                points=jnp.asarray(shared_proxy.points, jnp.float32)
                * self.norm.scale,
                eps=jnp.asarray(shared_proxy.eps, jnp.float32)
                * self.norm.scale)
            self.backend = bounds_ops.ProxyBackend(coreset=cs)
        else:
            self.backend = bounds_ops.make_backend(
                self.pct, kind=bound_backend, proxy_size=proxy_size,
                seed=e.seed)
        self._seed_pose = None
        if seed_pose_centered is not None:
            R_s, t_s = seed_pose_centered
            self._seed_pose = (np.asarray(R_s, np.float32),
                               np.asarray(t_s, np.float32)
                               * float(self.norm.scale))

        # Search-phase ICP target: a proxy coreset when it is smaller
        # than the full target (see _icp docstring; the incumbent sse is
        # always re-scored exactly).  LUT-backend engines get one built
        # on the side — bound evaluation reads the distance field, but
        # the search ICPs still iterate orders of magnitude faster on a
        # coreset than on the full target.
        self._icp_search_target = None
        if e.icp_search_on_proxy and proxy_size < self.nt:
            if isinstance(self.backend, bounds_ops.ProxyBackend):
                cs_pts = self.backend.coreset.points
                if cs_pts.shape[0] < self.nt:
                    self._icp_search_target = cs_pts
            elif not e.ref_compat_lut:
                from ..ops import coreset as coreset_ops
                self._icp_search_target = coreset_ops.build(
                    self.pct, size=proxy_size, seed=e.seed).points

        # Search-phase ICP source subsample (config.icp_search_subsample):
        # iteration-only — every incumbent is re-anchored by an exact
        # full-cloud NN pass in _icp, so this is a pure-cost knob.
        self._icp_search_src = None
        self._icp_search_trim = self.trim_keep
        k_sub = e.icp_search_subsample
        # Only when it cuts the per-iteration work >= 2x: below that the
        # compute win cannot cover the basin-quality risk (measured on
        # dragon, ns=2826: a 2048 subsample of the trimmed partial-
        # overlap scans landed worse incumbents — 61k nodes vs 18k).
        if 0 < 2 * k_sub <= self.ns:
            sub = np.sort(np.random.default_rng(
                e.seed + 7).permutation(self.ns)[:k_sub])
            self._icp_search_src = self.pcs[jnp.asarray(sub)]
            if self.trim_keep is not None:
                self._icp_search_trim = max(1, int(round(
                    k_sub * self.trim_keep / self.ns)))

        # Hierarchical source clusters for SEARCH bounds (config docstring).
        self.src_clusters = None
        src_k = e.source_coreset
        if src_k < 0:  # auto (config.py rule)
            import math as _math
            src_k = (0 if self.ns <= 2048 else int(min(4096, max(
                1024, 2 ** round(_math.log2(self.ns / 3))))))
        if src_k > 0 and self.ns > src_k and (
                self.trim_keep is None or e.source_coreset > 0):
            # Clusters compose with trimming since round 3 (search bounds
            # use the weighted member-level trim,
            # bounds.reduce_clustered_trimmed; ICP/incumbent SSE always
            # trim over the full source) — but only when source_coreset
            # is set EXPLICITLY: the trimmed cluster bounds carry
            # cluster-radius slack on both drop estimates and measured
            # ~6x more node expansions on the dragon workload, so the
            # auto rule keeps trimmed engines on full-source bounds.
            from ..ops import coreset as coreset_ops
            self.src_clusters = coreset_ops.build_weighted(
                self.pcs, size=src_k, seed=e.seed + 2)
            log.debug(f"Source clusters: {src_k} reps, max "
                      f"radius {float(jnp.max(self.src_clusters.deltas)):.4f}")

        # Multi-device mesh: rotation groups shard over `cubes`, source
        # points over `points` (parallel/sharding.py).  mesh=None keeps the
        # single-device fast path.
        self.mesh = mesh
        if self.mesh is None and e.mesh_cubes * e.mesh_points > 1:
            self.mesh = psh.make_mesh(e.mesh_cubes, e.mesh_points)

        # Incumbent (runtime state, fgoicp.hpp:61-64).
        self.best_sse = BIG
        self.best_rotation = np.eye(3, dtype=np.float32)
        self.best_translation = np.zeros(3, np.float32)
        self.last_rotation = np.eye(3, dtype=np.float32)
        self.last_translation = np.zeros(3, np.float32)
        self.stats = GoICPStats()
        self._tie = itertools.count()
        self._fingerprint = ckpt.cloud_fingerprint(pct, pcs)
        self._resumed_heap = None
        self._resumed_so3_state = None
        # Incumbent history for observability/visualization: one entry per
        # improvement, (wall_seconds_since_run_start, sse, R, t_normalized).
        # The reference only exposes the getters + debug logs
        # (fgoicp.hpp:32-43, fgoicp.cpp:85-87).
        self.history = []
        self._t_start = None
        # Certificate observability: the optimality gap the finished run
        # actually certifies (incumbent minus the lowest unexplored lower
        # bound), set by every outer-loop exit path.  <= sse_threshold
        # means certified optimal; None until a search ran.  Exists so
        # callers/tests can assert certification without reaching into
        # mode-specific state (the host heap is cleared in device mode).
        self.last_certified_gap = None
        # Min lb of terminal leaves the host loop closed (children below
        # rotation_min_span discarded, fgoicp.cpp:53) — folded into
        # last_certified_gap like the device loop's closed_lb so
        # frontier exhaustion cannot masquerade as a certificate.
        self._closed_leaf_lb = NO_CLOSED_LEAF

        # Static lane counts for stable jit shapes.
        self.n_groups = e.rotation_batch * 8
        # Twin incumbent sharing map, constant for the run: each lb-pass
        # group [G:2G) points at its fixed-rotation twin.  Built once:
        # each eager array op is a separate device dispatch.
        self._share = jnp.concatenate([
            jnp.full((self.n_groups,), -1, jnp.int32),
            jnp.arange(self.n_groups, dtype=jnp.int32)])

    # ----- reference-parity getters (fgoicp.hpp:32-43) -----
    def get_best_error(self):
        return self.best_sse

    def get_best_transform(self):
        return self.best_rotation, self.best_translation

    def get_last_transform(self):
        return self.last_rotation, self.last_translation

    # ------------------------------------------------------------------
    def _icp(self, R0, t0, active, convergence, search=False,
             max_iter=None):
        """Batched ICP; the returned sse is always EXACT on the full
        target (it feeds the pruning incumbent).

        search=True routes the ICP ITERATIONS against the proxy coreset
        when one exists (~4x fewer NN targets per iteration) and onto the
        source subsample when one is configured (icp_search_subsample);
        the final pose is then re-scored with one exact full-cloud NN
        pass, so the incumbent stays a true achievable SSE and the
        certificate is unaffected.  The pose itself may differ from a
        full-cloud ICP by O(coreset/subsample radius) — irrelevant
        mid-search, and the final polish (search=False) always runs the
        full source against the full target."""
        target = self.pct
        src, trim = self.pcs, self.trim_keep
        if search and self.mesh is None:
            if self._icp_search_target is not None:
                target = self._icp_search_target
            if self._icp_search_src is not None:
                src, trim = self._icp_search_src, self._icp_search_trim
        mi = max_iter if max_iter is not None else self.engine.icp_max_iter
        if self.mesh is not None:
            sse, R, t = pbnb.icp_sharded(
                self.pct, self.pcs, R0, t0, mesh=self.mesh, active=active,
                max_iter=mi,
                convergence_threshold=convergence, trim_keep=self.trim_keep)
        else:
            sse, R, t = icp_model.icp_batched(
                target, src, R0, t0, active=active,
                max_iter=mi,
                convergence_threshold=convergence, trim_keep=trim)
            if target is not self.pct or src is not self.pcs:
                sse = icp_model.exact_sse_batched(
                    self.pct, self.pcs, R, t, trim_keep=self.trim_keep)
        # ONE batched fetch: separate np.asarray calls are three
        # serialized device->host round trips.
        return jax.device_get((sse, R, t))

    def _icp_padded(self, R0, t0, n_active, convergence, search=False,
                    width=None, max_iter=None):
        """ICP in chunks of the fixed lane width (pads the tail with
        inactive identity lanes) so every call shares one compiled
        program regardless of candidate count.

        `width` overrides the engine lane width: the single-pose final
        polish runs width=1 — lanes compute in lockstep whether active or
        not, so padding 1 pose to 16 lanes wastes 15/16 of the NN work
        — at the cost of one extra compiled program."""
        w = width or self.engine.icp_width
        n = len(R0)
        outs = []
        for i in range(0, n, w):
            Rc = np.asarray(R0[i:i + w], np.float32)
            tc = np.asarray(t0[i:i + w], np.float32)
            k = len(Rc)
            if k < w:
                Rc = np.concatenate(
                    [Rc, np.tile(np.eye(3, dtype=np.float32),
                                 (w - k, 1, 1))])
                tc = np.concatenate([tc, np.zeros((w - k, 3), np.float32)])
            active = np.arange(w) < max(0, min(n_active - i, w))
            # numpy args transfer WITH the jit dispatch; eager
            # jnp.asarray staging would be three extra transfers.
            sse, R, t = self._icp(Rc, tc, active, convergence,
                                  search=search, max_iter=max_iter)
            outs.append((sse[:k], R[:k], t[:k]))
        return tuple(np.concatenate([o[j] for o in outs]) for j in range(3))

    def _initial_icp(self):
        """Seed the incumbent with cascaded multi-start ICP (stage 1 at
        the reference's eps=0.05; tighter warm-restart + full-cloud
        polish stages only when uncertified — config.icp_seed_fine_conv
        / icp_seed_polish rationale).

        The reference starts from identity only (fgoicp.cpp:12-14); with
        engine.icp_multi_start, one batched call additionally starts from
        the 8 rotation-cube octant centers and the 6 face centers (the
        +-90 degree rotations about each axis — scan pairs routinely sit
        a quarter-turn apart, and a start in the right basin collapses
        the whole BnB to a gap check).  15 starts fill one icp_width=16
        lane batch, so the seeding costs a single device call.
        """
        if self._seed_pose is not None:
            # An external seeding pass (serving) already swept the
            # multi-start set; start from its pose (+identity as the
            # reference's own start, fgoicp.cpp:12) instead of redoing
            # the sweep.
            R0 = np.stack([self._seed_pose[0],
                           np.eye(3, dtype=np.float32)])
            t0 = np.stack([self._seed_pose[1], np.zeros(3, np.float32)])
        elif self.engine.icp_multi_start:
            R0 = geo.multi_start_rotations()
            t0 = np.zeros((len(R0), 3), np.float32)
        else:
            R0 = np.eye(3, dtype=np.float32)[None]
            t0 = np.zeros((len(R0), 3), np.float32)
        sse, R, t = self._icp_padded(
            R0, t0, len(R0), self.engine.icp_convergence_init, search=True)
        k = int(np.argmin(sse[:len(R0)]))
        self.best_sse = float(sse[k])
        self.best_rotation, self.best_translation = R[k], t[k]
        self.stats.icp_runs += len(R0)
        e = self.engine
        if self.best_sse > self.sse_threshold and len(R0) > 1:
            # Cascade stage 2 (config.icp_seed_fine_conv doc): the 5%
            # cutoff quits on trimmed partial-overlap plateaus — warm-
            # restart the sweep from the stage-1 poses with a tighter
            # cutoff so true basins rank first.  Certifying workloads
            # never reach this.  A seed-pose run (serving fallback)
            # widens back to the FULL multi-start set here: the pair is
            # in fallback precisely because the batch sweep's winner
            # was wrong, so warm-restarting only that wrong basin (+
            # identity) would skip the very starts the cascade rescues
            # hard pairs with.
            if self._seed_pose is not None and e.icp_multi_start:
                starts = geo.multi_start_rotations(include_identity=False)
                R = np.concatenate([
                    np.asarray(R[:len(R0)], np.float32), starts])
                t = np.concatenate([
                    np.asarray(t[:len(R0)], np.float32),
                    np.zeros((len(starts), 3), np.float32)])
            sse, R, t = self._icp_padded(
                R, t, len(R), e.icp_seed_fine_conv, search=True)
            k = int(np.argmin(sse[:len(R)]))
            self.stats.icp_runs += len(R)
            if float(sse[k]) < self.best_sse:
                self.best_sse = float(sse[k])
                self.best_rotation, self.best_translation = R[k], t[k]
        if e.icp_seed_polish and self.best_sse > self.sse_threshold \
                and len(R0) > 1:
            # Cascade stage 3 (config.icp_seed_polish doc): the search
            # (subsample/proxy) sweep stalls terminally on hard-pair
            # plateaus; re-descend the best fine-sweep basins on the
            # FULL clouds with a tighter cutoff.
            kk = np.argsort(sse[:len(R)])[:e.icp_seed_polish_width]
            sse2, R2, t2 = self._icp_padded(
                R[kk], t[kk], len(kk), e.icp_seed_polish_conv,
                search=False, width=e.icp_seed_polish_width,
                max_iter=e.icp_seed_polish_iters)
            k2 = int(np.argmin(sse2[:len(kk)]))
            self.stats.icp_runs += len(kk)
            if float(sse2[k2]) < self.best_sse:
                self.best_sse = float(sse2[k2])
                self.best_rotation = R2[k2]
                self.best_translation = t2[k2]
        self._record_improvement()
        log.info(f"Initial ICP best error: {self.best_sse}",
                 "\n\tRotation:\n", self.best_rotation,
                 "\n\tTranslation: ", self.best_translation)

    def _final_icp(self):
        """ICP polish, eps=0.0005 (fgoicp.cpp:22-23)."""
        sse, R, t = self._icp_padded(
            np.asarray(self.best_rotation, np.float32)[None],
            np.asarray(self.best_translation, np.float32)[None],
            1, self.engine.icp_convergence_final, width=1)
        self.best_sse = float(sse[0])
        self.best_rotation, self.best_translation = R[0], t[0]
        self.stats.icp_runs += 1

    # ------------------------------------------------------------------
    def _spawn_children(self, popped):
        """Octree-split popped rotation nodes; classify by SO(3) tests.

        Returns (eval_list, requeued) where eval_list holds in-SO(3)
        children [(x, y, z, span)] and requeued were pushed back with
        stale parent bounds (fgoicp.cpp:50-66).
        """
        eval_list = []
        unrefined = []
        for (lb, _, item) in popped:
            x, y, z, span, ub = item[:5]
            # Nodes carry their inner-BnB best translation (items 5:8;
            # resumed pre-r5 checkpoints lack it -> t=0, the multi-start
            # sweep's own start).
            t_item = tuple(item[5:8]) if len(item) >= 8 \
                else (0.0, 0.0, 0.0)
            child_span = span / 2.0
            if child_span < self.engine.rotation_min_span:  # fgoicp.cpp:53
                # Closing a terminal leaf: its lb keeps bounding the
                # certificate gap.  Evaluated leaves (center inside
                # SO(3)) got their leaf-claim ICP refine at evaluation
                # time (_refine_candidates); outside-center requeue-
                # quirk leaves were NEVER evaluated — give a claiming
                # one its refine now (from the cube-center best-effort
                # rotation, t0=0, like the multi-start sweep) before
                # the subtree closes.
                if (x * x + y * y + z * z > 1.0
                        and lb < self.best_sse - self.sse_threshold):
                    unrefined.append((x, y, z) + t_item)
                self._closed_leaf_lb = min(self._closed_leaf_lb,
                                           float(lb))
                continue
            self.stats.rotation_nodes += 1
            for j in range(8):
                cx = x - child_span + ((j >> 0) & 1) * span
                cy = y - child_span + ((j >> 1) & 1) * span
                cz = z - child_span + ((j >> 2) & 1) * span
                r2 = cx * cx + cy * cy + cz * cz
                abs_sum = abs(cx) + abs(cy) + abs(cz)
                overlaps = (r2 - 2 * child_span * abs_sum
                            + 3 * child_span * child_span) <= 1.0
                if not overlaps:
                    continue
                if r2 > 1.0:
                    # Overlapping but center outside SO(3): requeue with
                    # inherited parent bounds (and the parent's inner
                    # translation), unevaluated (ref quirk).
                    heapq.heappush(self._heap, (lb, next(self._tie),
                                                (cx, cy, cz, child_span,
                                                 ub) + t_item))
                    continue
                eval_list.append((cx, cy, cz, child_span))
        if unrefined:
            arr = np.asarray(unrefined, np.float32)
            R0 = np.asarray(geo.quat_cube_to_matrix(jnp.asarray(arr[:, :3])))
            t0 = arr[:, 3:6]
            sse, Ri, ti = self._icp_padded(
                R0, t0, len(R0), self.engine.icp_convergence_bnb,
                search=True)
            self.stats.icp_runs += len(R0)
            k = int(np.argmin(sse[:len(R0)]))
            if float(sse[k]) < self.best_sse:
                self.best_sse = float(sse[k])
                self.best_rotation, self.best_translation = Ri[k], ti[k]
                self._record_improvement()
        return eval_list

    @staticmethod
    @functools.partial(jax.jit, static_argnames=("g",))
    def _prep_children(arr, n, g):
        """Build the duplicated ub/lb lane inputs in one device call
        (a dozen eager dispatches otherwise)."""
        xyz = arr[:, :3]
        spans = arr[:, 3]
        R = geo.quat_cube_to_matrix(xyz)                      # [G, 3, 3]
        active = jnp.arange(g) < n
        # Lanes [0:G] = ub pass (fix_rot), [G:2G] = lb pass.
        R2 = jnp.concatenate([R, R], axis=0)
        spans2 = jnp.concatenate([spans, spans], axis=0)
        fix2 = jnp.concatenate([jnp.ones((g,), bool), jnp.zeros((g,), bool)])
        act2 = jnp.concatenate([active, active])
        return R, R2, spans2, fix2, act2

    @staticmethod
    @functools.partial(jax.jit, static_argnames=("g",))
    def _eval_outputs(st, g):
        """Fuse the per-call readback of an inner-BnB state into ONE
        device computation (each eager slice/min/sum op + separate
        np.asarray is its own dispatch and device->host round trip)."""
        lb_raw = jnp.minimum(st.best_ub[g:], st.best_err[g:])
        return (st.best_ub[:g], st.best_t[:g], lb_raw, st.dropped_lb[g:],
                jnp.sum(st.evaluated), st.steps, jnp.sum(st.dropped))

    def _evaluate_children(self, children):
        """One device call: ub-pass + lb-pass inner BnB for all children."""
        e = self.engine
        g = self.n_groups
        n = len(children)
        arr = np.zeros((g, 4), np.float32)
        arr[:n] = np.asarray(children, np.float32)
        # numpy arg transfers with the jit dispatch (no eager staging).
        R, R2, spans2, fix2, act2 = self._prep_children(arr, n, g)

        if self.src_clusters is not None:
            search_pcs = self.src_clusters.reps
            pw, pd = self.src_clusters.weights, self.src_clusters.deltas
        else:
            search_pcs, pw, pd = self.pcs, None, None
        # Each lb-pass group [g:2g) may adopt its fixed-rotation twin's
        # incumbent (relaxed objective <= fixed objective pointwise).
        share = self._share

        if self.mesh is not None and e.frontier_mode == "pooled":
            st = pbnb.bnb_r3_pooled_sharded(
                self.backend, search_pcs, R2, spans2, fix2,
                jnp.float32(self.best_sse), jnp.float32(self.sse_threshold),
                mesh=self.mesh, group_active=act2,
                min_span=e.translation_min_span, lanes=e.pool_lanes,
                capacity=e.pool_capacity,
                ref_compat_gamma=e.ref_compat_gamma, trim_keep=self.trim_keep,
                point_weights=pw, point_deltas=pd, err_share_from=share,
                trim_ns=(self.ns if self.trim_keep is not None else None),
                pool_update=e.pool_update)
        elif self.mesh is not None:
            st = pbnb.bnb_r3_sharded(
                self.backend, self.pcs, R2, spans2, fix2,
                jnp.float32(self.best_sse), jnp.float32(self.sse_threshold),
                mesh=self.mesh, group_active=act2,
                min_span=e.translation_min_span, batch=e.translation_batch,
                capacity=e.frontier_capacity,
                ref_compat_gamma=e.ref_compat_gamma, trim_keep=self.trim_keep)
        elif e.frontier_mode == "pooled":
            st = pool_frontier.bnb_r3_pooled(
                self.backend, search_pcs, R2, spans2, fix2,
                jnp.float32(self.best_sse), jnp.float32(self.sse_threshold),
                group_active=act2, min_span=e.translation_min_span,
                lanes=e.pool_lanes, capacity=e.pool_capacity,
                ref_compat_gamma=e.ref_compat_gamma, trim_keep=self.trim_keep,
                point_weights=pw, point_deltas=pd, err_share_from=share,
                trim_ns=(self.ns if self.trim_keep is not None else None),
                pool_update=e.pool_update)
        else:
            st = frontier_ops.bnb_r3_batched(
                self.backend, self.pcs, R2, spans2, fix2,
                jnp.float32(self.best_sse), jnp.float32(self.sse_threshold),
                group_active=act2, min_span=e.translation_min_span,
                batch=e.translation_batch, capacity=e.frontier_capacity,
                ref_compat_gamma=e.ref_compat_gamma, trim_keep=self.trim_keep)

        # Rotation lb = the lb-pass result.  min(achieved, pruning
        # incumbent): at gap termination best_err <= relaxed_min +
        # sse_threshold, so this keeps the reference's threshold-slack
        # guarantee even when twin err-sharing ends a search early
        # (pool_frontier err_share_from).  The dropped_lb clamp keeps the
        # bound sound when frontier-capacity overflow discarded an
        # unexplored node that could hold the min-lb witness (frontier.py
        # module doc) — without it the certificate is silently voided.
        (ub_g, bt_g, lb_raw_g, drop_g, evaluated, steps, dropped), R = \
            jax.device_get((self._eval_outputs(st, g), R))
        ub = ub_g[:n]
        best_t = bt_g[:n]
        lb_raw = lb_raw_g[:n]
        drop_clamp = drop_g[:n]
        lb = np.minimum(lb_raw, drop_clamp)
        if np.any(drop_clamp < lb_raw):
            log.warning(
                f"Inner-BnB pool overflow clamped {int(np.sum(drop_clamp < lb_raw))} "
                f"rotation lower bound(s); the search stays exact but "
                f"slower — increase engine.pool_capacity")
        self.stats.translation_nodes += int(evaluated)
        self.stats.inner_loop_steps += int(steps)
        self.stats.dropped_nodes += int(dropped)
        return R, ub, best_t, lb

    def _refine_candidates(self, R, children, ub, best_t, lb=None):
        """Batched ICP on children passing the trigger (fgoicp.cpp:74-88),
        compacted into fixed-width chunks (typically 1-2 triggers).

        Beyond the reference: the triggered set is topped up to a full
        icp_width lane batch with the lowest-ub non-triggered children
        (engine.icp_refine_best).  A batched ICP call costs the same for
        1 lane or 16, so the extra lanes are free basin-finding attempts
        — they break the local-minimum stall regime where a wrong-basin
        incumbent starves the 1.8x trigger and the search grinds
        cube-by-cube (measured 84 outer steps vs 6 on bunny when an
        early ICP landed at sse 10.4).  Extra refinement can only
        improve the incumbent, never weaken the certificate.

        Terminal-leaf claim refine: a child at the finest rotation level
        (its own children would fall below rotation_min_span and be
        discarded, fgoicp.cpp:53) whose lb still claims an improvement
        over the incumbent (lb < best_sse - sse_threshold) gets an ICP
        lane REGARDLESS of its ub.  The rotation tree is finite, so a
        subtree may only be closed once it is certified or refined; the
        inner translation min_span floors leaf ubs (~10x the achievable
        SSE on the 90-degree bun000/bun090 pair), so ub-ranked refine
        alone starves exactly the basins the certificate still owes —
        measured: the trimmed bun090 search exhausted 202 outer steps
        and returned a wrong 'global' optimum 7.7x above the true one."""
        n = len(children)
        trigger = ub[:n] < self.best_sse * self.engine.icp_trigger_factor
        if lb is not None and n > 0:
            spans = np.asarray([c[3] for c in children], np.float32)
            terminal = spans / 2.0 < self.engine.rotation_min_span
            claim = lb[:n] < self.best_sse - self.sse_threshold
            trigger = trigger | (terminal & claim)
        idxs = np.flatnonzero(trigger)
        self.stats.icp_triggered += int(idxs.size)
        w = self.engine.icp_width
        if self.engine.icp_refine_best and idxs.size < w and n > 0:
            in_trig = np.zeros(n, bool)
            in_trig[idxs] = True
            fill = [int(i) for i in np.argsort(ub[:n]) if not in_trig[i]]
            idxs = np.concatenate(
                [idxs, np.asarray(fill[:w - idxs.size], np.int64)])
        if idxs.size == 0:
            return
        self.stats.icp_runs += int(idxs.size)
        w = self.engine.icp_width
        for i in range(0, idxs.size, w):
            chunk = idxs[i:i + w]
            R0 = np.asarray(R[:n][chunk], np.float32)
            t0 = np.asarray(best_t[chunk], np.float32)
            sse, Ri, ti = self._icp_padded(
                R0, t0, len(chunk), self.engine.icp_convergence_bnb,
                search=True)
            k = int(np.argmin(sse[:len(chunk)]))
            if sse[k] < self.best_sse:
                self.best_sse = float(sse[k])
                self.best_rotation, self.best_translation = Ri[k], ti[k]
                self._record_improvement()
                log.debug(f"New best error: {self.best_sse}",
                          "\n\tRotation:\n", self.best_rotation,
                          "\n\tTranslation: ",
                          np.asarray(self.norm.restore_translation(
                              self.best_rotation, self.best_translation)))

    # ----- checkpoint/resume (absent in the reference; SURVEY §5) -----
    def save_checkpoint(self, path: str):
        """Persist the outer frontier + incumbent (atomic, fingerprinted)."""
        ckpt.save(
            path, heap=list(getattr(self, "_heap", [])), tie=next(self._tie),
            best_sse=self.best_sse, best_rotation=self.best_rotation,
            best_translation=self.best_translation,
            stats=dataclasses.asdict(self.stats),
            fingerprint=self._fingerprint,
            closed_leaf_lb=self._closed_leaf_lb)

    def load_checkpoint(self, path: str):
        """Restore a checkpoint saved against the same cloud pair; the next
        run() skips the initial ICP and resumes the outer BnB loop.

        Dispatches on the checkpoint kind: host-heap checkpoints resume
        the host outer loop, device-state (SO3State) checkpoints resume
        the chunked device loop; kind/mode mismatches raise with the
        outer_mode to use (utils/checkpoint._check_header)."""
        if self.engine.outer_mode == "device":
            st = ckpt.load_device_state(path, fingerprint=self._fingerprint)
            from ..ops import so3_frontier as so3_ops
            state = so3_ops.state_from_arrays(st["state_arrays"])
            self._resumed_so3_state = state
            self.best_sse = float(state.best_sse)
            self.best_rotation = np.asarray(state.best_R)
            self.best_translation = np.asarray(state.best_t)
            self.stats = GoICPStats(**st["stats"])
            log.info(f"Resumed device checkpoint {path}: "
                     f"best_sse={self.best_sse}, "
                     f"outer_steps={int(state.outer_steps)}")
            return
        st = ckpt.load(path, fingerprint=self._fingerprint)
        self.best_sse = st["best_sse"]
        self.best_rotation = st["best_rotation"]
        self.best_translation = st["best_translation"]
        self.stats = GoICPStats(**st["stats"])
        self._tie = itertools.count(st["tie"])
        self._resumed_heap = st["heap"]
        self._closed_leaf_lb = min(self._closed_leaf_lb,
                                   st["closed_leaf_lb"])
        log.info(f"Resumed checkpoint {path}: best_sse={self.best_sse}, "
                 f"{len(self._resumed_heap)} frontier nodes")

    def load_checkpoints(self, paths):
        """Elastic multi-host recovery: merge several checkpoints — one
        per host of a dead partitioned run (parallel/distributed.py) —
        into this model's resume state, then run() standalone (or as a
        re-partitioned smaller cluster's rank 0).

        Soundness: the multi-host partition keeps every unexplored
        SO(3) subtree in exactly one host's frontier, so the UNION of
        the hosts' frontiers plus the min incumbent re-covers the
        entire not-yet-pruned region — resuming ONE host's checkpoint
        alone would silently drop the other hosts' subtrees and void
        the optimality certificate.  All checkpoints must carry this
        cloud pair's fingerprint and the kind matching
        engine.outer_mode.  Counters sum; wall_seconds takes the max.
        """
        paths = list(paths)
        if not paths:
            raise ValueError("load_checkpoints needs at least one path")
        if len(paths) == 1:
            return self.load_checkpoint(paths[0])

        def merge_stats(acc, new):
            if acc is None:
                return dict(new)
            return {k: (max(acc[k], v) if k == "wall_seconds"
                        else acc[k] + v) for k, v in new.items()}

        if self.engine.outer_mode == "device":
            from ..ops import so3_frontier as so3_ops
            states, stats = [], None
            for p in paths:
                st = ckpt.load_device_state(
                    p, fingerprint=self._fingerprint)
                states.append(so3_ops.state_from_arrays(st["state_arrays"]))
                stats = merge_stats(stats, st["stats"])
            merged = so3_ops.merge_states(states)
            self._resumed_so3_state = merged
            self.best_sse = float(merged.best_sse)
            self.best_rotation = np.asarray(merged.best_R)
            self.best_translation = np.asarray(merged.best_t)
            self.stats = GoICPStats(**stats)
            log.info(f"Merged {len(paths)} device checkpoints: "
                     f"best_sse={self.best_sse}")
            return
        heap, tie, stats = [], 0, None
        best = (BIG, None, None)
        for p in paths:
            st = ckpt.load(p, fingerprint=self._fingerprint)
            self._closed_leaf_lb = min(self._closed_leaf_lb,
                                       st["closed_leaf_lb"])
            for lb, _t, node in st["heap"]:
                heap.append((lb, tie, node))
                tie += 1
            if st["best_sse"] < best[0]:
                best = (st["best_sse"], st["best_rotation"],
                        st["best_translation"])
            stats = merge_stats(stats, st["stats"])
        if best[1] is not None:
            self.best_sse = best[0]
            self.best_rotation = best[1]
            self.best_translation = best[2]
        self.stats = GoICPStats(**stats)
        self._tie = itertools.count(tie)
        self._resumed_heap = heap
        log.info(f"Merged {len(paths)} host checkpoints: "
                 f"best_sse={self.best_sse}, {len(heap)} frontier nodes")

    def _record_improvement(self):
        import time as _time
        elapsed = 0.0 if self._t_start is None else _time.time() - self._t_start
        self.history.append((elapsed, self.best_sse,
                             np.asarray(self.best_rotation),
                             np.asarray(self.best_translation)))

    def _maybe_checkpoint(self):
        e = self.engine
        if e.checkpoint_path and e.checkpoint_every > 0 and \
                self.stats.outer_steps % e.checkpoint_every == 0:
            self.save_checkpoint(e.checkpoint_path)

    def root_nodes(self):
        """Initial outer-frontier nodes: the full quaternion cube
        (fgoicp.cpp:36).  The multi-host engine overrides the seeding."""
        return [(0.0, 0.0, 0.0, 1.0)]

    def seed_heap(self):
        if self._resumed_heap is not None:
            self._heap = list(self._resumed_heap)
            heapq.heapify(self._heap)
            self._resumed_heap = None
        else:
            self._heap = []
            for (x, y, z, span) in self.root_nodes():
                heapq.heappush(
                    self._heap,
                    (0.0, next(self._tie),
                     (x, y, z, span, self.best_sse, 0.0, 0.0, 0.0)))

    def heap_min_lb(self) -> float:
        """Lowest unexplored lower bound (the local optimality gap floor)."""
        return self._heap[0][0] if self._heap else float(BIG)

    def outer_converged(self) -> bool:
        """Local termination test (fgoicp.cpp:44-47)."""
        return (not self._heap or
                self.best_sse - self._heap[0][0] <= self.sse_threshold)

    def outer_step(self) -> bool:
        """One outer BnB iteration: pop a batch, evaluate the children's
        inner searches, refine, push survivors.  Returns False when the
        frontier is exhausted."""
        e = self.engine
        if not self._heap:
            return False
        popped = []
        while self._heap and len(popped) < e.rotation_batch:
            popped.append(heapq.heappop(self._heap))
        children = self._spawn_children(popped)
        for i in range(0, len(children), self.n_groups):
            chunk = children[i:i + self.n_groups]
            R, ub, best_t, lb = self._evaluate_children(chunk)
            self.stats.rotation_children += len(chunk)
            self.last_rotation = R[len(chunk) - 1]
            self.last_translation = best_t[len(chunk) - 1]
            self._refine_candidates(R, chunk, ub, best_t, lb=lb)
            for k, (cx, cy, cz, cspan) in enumerate(chunk):
                if lb[k] >= self.best_sse:  # fgoicp.cpp:92
                    self.stats.rotation_pruned += 1
                    continue
                heapq.heappush(
                    self._heap,
                    (float(lb[k]), next(self._tie),
                     (cx, cy, cz, cspan, float(ub[k]),
                      float(best_t[k][0]), float(best_t[k][1]),
                      float(best_t[k][2]))))
        self.stats.outer_steps += 1
        self._maybe_checkpoint()
        if e.debug_checks:
            from ..utils import sanitize
            sanitize.check_heap(self._heap)
            sanitize.check_incumbent(self)
        return True

    def _branch_and_bound_so3(self):
        """Outer loop (fgoicp.cpp:32-100), batched over rotation nodes."""
        if self.engine.outer_mode == "device":
            return self._bnb_so3_device()
        self.seed_heap()
        while self._heap and not self.outer_converged():
            self.outer_step()
        self.last_certified_gap = float(
            self.best_sse - min(self.heap_min_lb(), self._closed_leaf_lb))
        return self.best_sse

    # SO3State counter field -> GoICPStats field (device outer mode).
    _DEVICE_COUNTERS = {
        "outer_steps": "outer_steps",
        "nodes_expanded": "rotation_nodes",
        "children_evaluated": "rotation_children",
        "inner_nodes": "translation_nodes",
        "icp_runs": "icp_runs",
        "icp_triggered": "icp_triggered",
        "pruned": "rotation_pruned",
    }
    _DEVICE_MAX_OUTER = 10000   # overall safety valve (host loop has none;
    #                             chunked device calls respect it too)

    def _flush_device_counters(self, st, last):
        """Add the counter DELTA since `last` into self.stats; SO3State
        counters are cumulative across chunk/resume boundaries."""
        for f, g in self._DEVICE_COUNTERS.items():
            cur = int(getattr(st, f))
            setattr(self.stats, g, getattr(self.stats, g) + cur - last[f])
            last[f] = cur

    def _sanitize_device_state(self, st):
        """Run the search-state sanitizer on a retrieved SO3State when
        engine.debug_checks is on (chunk boundaries + final retrieval)."""
        if self.engine.debug_checks:
            from ..utils import sanitize
            sanitize.check_device_state(st)

    def _save_device_checkpoint(self, st):
        ckpt.save_device_state(
            self.engine.checkpoint_path,
            state_arrays={f: np.asarray(getattr(st, f))
                          for f in st._fields},
            stats=dataclasses.asdict(self.stats),
            fingerprint=self._fingerprint)

    def _device_call_fn(self):
        """Build ``call(init_state, max_outer) -> SO3State`` bound to
        this model's engine/backend.  Shared by the single-host chunk
        driver below and the multi-host partition driver
        (parallel/distributed.py).  The incumbent args are re-read from
        ``self`` at each call but IGNORED whenever ``init_state`` is
        given (the state carries its own incumbent —
        so3_frontier.so3_bnb_device docstring)."""
        from ..ops import so3_frontier as so3_ops
        e = self.engine
        if self.src_clusters is not None:
            search_pcs = self.src_clusters.reps
            pw, pd = self.src_clusters.weights, self.src_clusters.deltas
        else:
            search_pcs, pw, pd = self.pcs, None, None
        kw = dict(
            rotation_batch=e.rotation_batch, capacity=e.so3_capacity,
            rotation_min_span=e.rotation_min_span,
            translation_min_span=e.translation_min_span,
            pool_lanes=e.pool_lanes, pool_capacity=e.pool_capacity,
            ref_compat_gamma=e.ref_compat_gamma,
            icp_width=e.icp_width, icp_max_iter=e.icp_max_iter,
            icp_convergence=jnp.float32(e.icp_convergence_bnb),
            icp_trigger_factor=e.icp_trigger_factor,
            icp_refine_best=e.icp_refine_best,
            trim_ns=(self.ns if self.trim_keep is not None else None),
            pool_update=e.pool_update)

        def call(init_state, max_outer):
            common = dict(point_weights=pw, point_deltas=pd,
                          icp_search_target=self._icp_search_target,
                          icp_search_src=self._icp_search_src,
                          icp_search_trim=self._icp_search_trim,
                          trim_keep=self.trim_keep,
                          init_state=init_state, max_outer=max_outer,
                          **kw)
            args = (self.backend, self.pct, self.pcs, search_pcs,
                    jnp.float32(self.best_sse),
                    jnp.asarray(self.best_rotation, jnp.float32),
                    jnp.asarray(self.best_translation, jnp.float32),
                    jnp.float32(self.sse_threshold))
            if self.mesh is not None:
                # (cubes x points) mesh: frontier replicated, child
                # evaluation sliced over cubes, clouds over points.
                return pbnb.so3_bnb_device_sharded(
                    *args, mesh=self.mesh, **common)
            return so3_ops.so3_bnb_device(*args, **common)

        return call

    def _device_adopt(self, st, hist_seen, last=None):
        """Fold a finished device SO3State into the host-side model:
        improvement-history ring entries past `hist_seen`, the
        incumbent, counter deltas (when `last` is given), and clear the
        host heap.  Per-entry wall-clock is not observable from inside
        a device call, so history entries carry the retrieval elapsed
        time instead."""
        import time as _time
        elapsed = (0.0 if self._t_start is None
                   else _time.time() - self._t_start)
        n_hist = int(st.hist_len)
        ring_cap = st.hist_sse.shape[0]
        if hist_seen >= ring_cap:
            # Resumed from a checkpoint whose ring was already saturated:
            # hist_len stays pinned at capacity while post-resume
            # improvements keep overwriting the LAST slot, so treat that
            # slot as unseen — otherwise every post-resume improvement
            # vanishes from model.history.
            hist_seen = ring_cap - 1
        for j in range(hist_seen, n_hist):
            if (self.history
                    and float(st.hist_sse[j]) >= self.history[-1][1]):
                continue  # saturated last slot unchanged since resume
            self.history.append(
                (elapsed, float(st.hist_sse[j]),
                 np.asarray(st.hist_R[j]), np.asarray(st.hist_t[j])))
        if n_hist == ring_cap:
            log.debug("device history ring saturated; intermediate "
                      "improvements were overwritten into the last slot")
        if float(st.best_sse) < self.best_sse:
            self.best_sse = float(st.best_sse)
            self.best_rotation = np.asarray(st.best_R)
            self.best_translation = np.asarray(st.best_t)
        self.last_rotation = np.asarray(st.best_R)
        self.last_translation = np.asarray(st.best_t)
        if last is not None:
            self._flush_device_counters(st, last)
        self._heap = []
        if self.engine.debug_checks:
            from ..utils import sanitize
            sanitize.check_device_state(st)
            sanitize.check_incumbent(self)

    def _bnb_so3_device(self):
        """Whole nested BnB on device (ops/so3_frontier.py).

        Amortizes the per-outer-step dispatch cost.  Incumbent history
        IS kept: the device loop records each improvement into a fixed
        ring (SO3State.hist_*) folded into self.history on retrieval.

        Checkpoint/resume IS supported (round 3): with checkpoint_path
        set, the search runs in checkpoint_every-step CHUNKS — each
        chunk one device call resuming the previous chunk's SO3State
        (max_outer is traced, so chunks share one executable) — and the
        state pytree persists atomically between chunks.  Without a
        checkpoint path the whole search stays ONE device call.

        Multi-host partitioning in device mode lives in
        parallel/distributed.py (chunked device calls with incumbent
        sync rounds between chunks)."""
        from ..ops import so3_frontier as so3_ops
        call = self._device_call_fn()
        e = self.engine
        st0 = self._resumed_so3_state
        self._resumed_so3_state = None
        last = {f: (0 if st0 is None else int(getattr(st0, f)))
                for f in self._DEVICE_COUNTERS}
        hist_seen = 0 if st0 is None else int(st0.hist_len)
        # The step valve is RELATIVE to the resume point: outer_steps is
        # also the observability counter, and elastic recovery SUMS the
        # per-host counters when merging crash checkpoints
        # (so3_frontier.merge_states) — an absolute valve would then
        # start (partially or fully) exhausted and silently skip the
        # device search the merged frontier exists for.
        valve = ((0 if st0 is None else int(st0.outer_steps))
                 + self._DEVICE_MAX_OUTER)

        chunk = (e.checkpoint_every
                 if (e.checkpoint_path and e.checkpoint_every > 0) else 0)
        # Every retrieved state comes back through ONE jax.device_get
        # (SO3State is ~0.5 MB): all downstream bookkeeping — counters,
        # history ring, checkpoint writes, the certificate gap — then
        # runs on host numpy.  Reading the fields eagerly would be ~20
        # blocking device->host round trips per retrieval.
        if chunk <= 0:
            st = jax.device_get(call(st0, valve))
        else:
            st = st0
            while True:
                start = 0 if st is None else int(st.outer_steps)
                cap = min(start + chunk, valve)
                st = jax.device_get(call(st, cap))
                self._sanitize_device_state(st)
                self._flush_device_counters(st, last)  # updates `last`
                self._save_device_checkpoint(st)
                if int(st.outer_steps) < cap or cap >= valve:
                    break   # gap closed / frontier empty / safety valve
            # Counters already flushed chunk-by-chunk; mark them done.
            last = None
        # History ring entries fold in oldest-first (entries recorded
        # before a resume belong to the previous process).
        self._device_adopt(st, hist_seen, last)
        # A device search can end WITHOUT a certificate: the fixed
        # SO(3) frontier dropped a subtree (its lb bounds the gap open)
        # or max_outer truncated the loop.  Unlike inner-pool drops,
        # those subtrees are unrecoverable on device — re-certify with
        # the host loop, which restarts the octree from the root but
        # inherits the device incumbent, so pruning closes it fast.
        # (Host-side mirror of so3_frontier.certified_gap on the fetched
        # numpy state.)
        floor = min(float(st.lbs[0]), float(st.dropped_lb),
                    float(st.closed_lb))
        gap = -float(so3_ops.BIG) if floor >= float(so3_ops.INVALID) \
            else float(st.best_sse) - floor
        self.last_certified_gap = gap
        if gap > self.sse_threshold:
            log.warning(
                f"Device SO(3) search ended with an open certificate "
                f"gap ({gap:.3g} > {self.sse_threshold:.3g}; frontier "
                f"overflow, max_outer, or a closed claim leaf) — "
                f"re-certifying with the host loop (raise "
                f"engine.so3_capacity to avoid this)")
            self.seed_heap()
            while self._heap and not self.outer_converged():
                self.outer_step()
            self.last_certified_gap = float(
                self.best_sse
                - min(self.heap_min_lb(), self._closed_leaf_lb))
        return self.best_sse

    # ------------------------------------------------------------------
    def run(self):
        """Full pipeline; returns (R, t) in the ORIGINAL (world) frame
        (fgoicp.cpp:10-30)."""
        t0 = time.time()
        self._t_start = t0
        if self._resumed_heap is None and self._resumed_so3_state is None:
            self._initial_icp()
        self._branch_and_bound_so3()
        self._final_icp()
        self._record_improvement()
        self.stats.wall_seconds = time.time() - t0
        t_world = np.asarray(self.norm.restore_translation(
            jnp.asarray(self.best_rotation), jnp.asarray(self.best_translation)))
        log.info(f"Searching over! Best Error: {self.best_sse}",
                 "\n\tRotation:\n", self.best_rotation,
                 "\n\tTranslation: ", t_world)
        return self.best_rotation, t_world

    @property
    def mse(self):
        return self.best_sse / self.ns


def register(config: Config, pct=None, pcs=None):
    """Config-driven entry (mirrors main.cpp:41-53)."""
    from ..io import load_cloud
    if pct is None:
        pct = load_cloud(config.io.target, config.params.target_subsample,
                         seed=config.engine.seed)
        log.info(f"Target point cloud ({len(pct)}) loaded from {config.io.target}")
    if pcs is None:
        pcs = load_cloud(config.io.source, config.params.source_subsample,
                         seed=config.engine.seed + 1)
        log.info(f"Source point cloud ({len(pcs)}) loaded from {config.io.source}")
    model = GoICP(
        pct, pcs, lut_resolution=config.params.lut_resolution,
        mse_threshold=config.params.mse_threshold, engine=config.engine,
        trim_fraction=(config.params.trim_fraction if config.params.trim else 0.0))
    R, t = model.run()
    return model, R, t
