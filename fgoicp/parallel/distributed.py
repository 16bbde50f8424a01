"""Multi-host Go-ICP: host-partitioned outer BnB + incumbent all-reduce.

The reference is a single process on a single GPU (SURVEY §2 parallelism
inventory).  This layer scales the OUTER SO(3) search across hosts, per
the BASELINE.json north star: the rotation cube is partitioned across
processes (octant round-robin, recursively for >8 hosts), each host runs
the full nested BnB on its partition with its local device mesh, and a
small fixed-size incumbent message is all-gathered every outer step so
every host prunes against the global best.

Protocol (one message per host per round, 18 floats):
    [best_sse, local_min_lb, idle_flag, R(9), t(3), heap_len, steal_max,
     valve_bound]
(valve_bound marks a device-mode host idled by the outer-step safety
valve — it votes idle for termination but CANNOT absorb stolen work,
so the steal plan skips it; always 0 in host mode)
Each sync round every host adopts the global-min incumbent, then runs up
to `engine.multihost_sync_every` outer steps (staleness bound: the
incumbent a host prunes against is at most that many outer steps old —
a stale incumbent is merely HIGHER, so pruning stays sound) before the
next collective.  Every decision taken at a sync point — termination,
incumbent adoption, donor/recipient selection for work stealing — is a
PURE FUNCTION of the gathered matrix, so all hosts always agree (that
purity, not wire precision, is the deadlock protection); the wire
additionally carries each f64 as an (hi, lo) f32 pair, preserving ~48
mantissa bits so decoded values track the sender's to ~2^-48 relative.
Global termination fires when
    min_h(best_sse_h) - min_h(local_min_lb_h) <= sse_threshold,
which also covers the all-heaps-empty case (min_lb = +inf).

Work stealing: when the gathered matrix shows at least one idle host and
a non-idle host with >= 2 frontier nodes, a second all-gather moves up to
`steal_max` nodes from the largest heap to the idle hosts (round-robin).
Donated nodes are popped from the donor, so each node lives in exactly
one heap and the BnB certificate is unaffected.  The second gather runs
iff the (shared) matrix says so — no host can skip the collective.

The communicator is pluggable: `JaxProcessCommunicator` rides
jax.experimental.multihost_utils over a real multi-process jax.distributed
runtime; `ThreadCommunicator` runs N simulated hosts in threads for tests
(tests/test_distributed.py) with identical semantics.

Both outer modes are supported (round 3): `outer_mode="host"` steps the
host heap between sync rounds; `outer_mode="device"` runs each host's
partition as multihost_sync_every-step CHUNKS of the on-device nested
BnB (ops/so3_frontier.py — the partition cells seed the device frontier
via initial_state, max_outer is traced so all chunks share one
executable), with the same 18-float sync protocol between chunks and
work stealing implemented as host-side surgery on the lb-sorted
SO3State rows.  A device search that stalls with an open certificate
(capacity drops / the step valve) falls back to the partitioned host
loop on ALL ranks together — the decision is a pure function of the
gathered matrix.
"""

from __future__ import annotations

import heapq
import threading
from typing import Optional, Sequence

import jax
import numpy as np

from ..config import EngineConfig
from ..models.goicp import BIG, GoICP
from ..utils import logging as log

_MSG_LEN = 18

_TIMEOUT_HINT = (
    "multi-host allgather timed out — a peer process is likely dead or "
    "hung (or still compiling a long chunk: raise "
    "engine.multihost_timeout_s above the worst-case chunk wall).  The "
    "collective cannot recover in place — the timed-out worker thread "
    "stays blocked inside it, so this error is terminal for the process; "
    "restart the job from the latest checkpoint (engine.checkpoint_path "
    "/ --resume, or GoICP.load_checkpoints for elastic recovery) with "
    "the surviving hosts.")


def split_f64_to_f32_pairs(vec: np.ndarray) -> np.ndarray:
    """[L] f64 -> [2L] f32 (hi, lo) with hi + lo ~= vec to ~2^-48
    relative (the lo residual is itself f32-rounded, so ~48-49 of the 52
    f64 mantissa bits survive — not bitwise lossless).

    The jax.distributed all-gather wire is float32; a single-rounded
    best_sse lets hosts disagree about threshold comparisons near the
    convergence boundary and deadlock in the collective.  The
    double-single split makes the wire error negligible (2^-48 vs
    f32's 2^-24); the actual deadlock protection is structural — every
    termination decision is a pure function of the DECODED matrix, which
    all hosts share bit-for-bit regardless of encode precision.
    """
    vec = np.asarray(vec, np.float64)
    hi = vec.astype(np.float32)
    lo = (vec - hi.astype(np.float64)).astype(np.float32)
    return np.concatenate([hi, lo])


def merge_f32_pairs_to_f64(mat: np.ndarray) -> np.ndarray:
    """Inverse of split_f64_to_f32_pairs over the last axis."""
    half = mat.shape[-1] // 2
    return (mat[..., :half].astype(np.float64)
            + mat[..., half:].astype(np.float64))


class ThreadCommunicator:
    """Barrier-synchronized all-gather across N threads (test double)."""

    def __init__(self, rank: int, size: int, shared: dict):
        self.rank = rank
        self.size = size
        self._shared = shared

    @classmethod
    def create(cls, n: int) -> Sequence["ThreadCommunicator"]:
        shared = {
            "fill": threading.Barrier(n),
            "drain": threading.Barrier(n),
            "slots": [None] * n,
        }
        return [cls(r, n, shared) for r in range(n)]

    def allgather(self, vec: np.ndarray,
                  timeout: Optional[float] = None) -> np.ndarray:
        s = self._shared
        s["slots"][self.rank] = np.asarray(vec, np.float64).copy()
        try:
            s["fill"].wait(timeout)
            out = np.stack(s["slots"])
            # everyone has read before the next round writes
            s["drain"].wait(timeout)
        except threading.BrokenBarrierError:
            raise RuntimeError(_TIMEOUT_HINT) from None
        return out


class JaxProcessCommunicator:
    """All-gather over the jax.distributed runtime (real multi-host)."""

    def __init__(self):
        import jax
        self.rank = jax.process_index()
        self.size = jax.process_count()

    def allgather(self, vec: np.ndarray,
                  timeout: Optional[float] = None) -> np.ndarray:
        from jax.experimental import multihost_utils

        def gather():
            wire = multihost_utils.process_allgather(
                split_f64_to_f32_pairs(vec))
            return merge_f32_pairs_to_f64(np.asarray(wire))

        if timeout is None:
            return gather()
        # The jax collective blocks forever on a dead peer; run it on a
        # worker so the timeout converts the hang into a clean error with
        # a recovery hint.  The worker thread stays blocked in the
        # collective — acceptable, the error path is terminal.
        box: list = []
        err: list = []

        def work():
            try:
                box.append(gather())
            except Exception as exc:  # surfaced on the caller thread
                err.append(exc)

        th = threading.Thread(target=work, daemon=True)
        th.start()
        th.join(timeout)
        if th.is_alive():
            raise RuntimeError(_TIMEOUT_HINT)
        if err:
            raise err[0]
        return box[0]


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> JaxProcessCommunicator:
    """Bring up jax.distributed and return a communicator."""
    import jax
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return JaxProcessCommunicator()


def partition_root(rank: int, size: int):
    """Recursively split the quaternion cube until there are >= size
    cells; return the cells owned by `rank` (round-robin)."""
    cells = [(0.0, 0.0, 0.0, 1.0)]
    while len(cells) < size:
        nxt = []
        for (x, y, z, span) in cells:
            half = span / 2.0
            for j in range(8):
                nxt.append((x - half + ((j >> 0) & 1) * span,
                            y - half + ((j >> 1) & 1) * span,
                            z - half + ((j >> 2) & 1) * span,
                            half))
        cells = nxt
    return [c for i, c in enumerate(cells) if i % size == rank]


class MultiHostGoICP(GoICP):
    """GoICP over a partition of SO(3), globally synchronized each step."""

    def __init__(self, pct, pcs, comm, **kwargs):
        super().__init__(pct, pcs, **kwargs)
        self.comm = comm
        self._timeout = (self.engine.multihost_timeout_s
                         if self.engine.multihost_timeout_s > 0 else None)
        self.sync_rounds = 0
        self.idle_rounds = 0
        self.donated_nodes = 0
        self.stolen_nodes = 0
        # Device-mode step valve; re-anchored relative to the resumed
        # state's counter at driver start (_bnb_so3_device_multihost).
        self._device_valve = self._DEVICE_MAX_OUTER

    def root_nodes(self):
        return partition_root(self.comm.rank, self.comm.size)

    def _locally_idle(self) -> bool:
        """True when this host would not run an outer step this round."""
        return not self._heap or self.outer_converged()

    def _round_timeout(self):
        """Dead-peer timeout for the next incumbent gather.  The first
        two rounds absorb one-time costs a liveness timeout must not
        trip on — process-cold executable load before round 1 and the
        first device-chunk compile (potentially minutes cold) before
        round 2 — so they get 10x."""
        if self._timeout is None:
            return None
        return self._timeout * 10.0 if self.sync_rounds < 2 \
            else self._timeout

    def _message(self) -> np.ndarray:
        msg = np.empty((_MSG_LEN,), np.float64)
        msg[0] = self.best_sse
        # The certificate floor, not just the heap minimum: terminal
        # leaves this host already closed (goicp._closed_leaf_lb) keep
        # bounding the gap — without the fold, every rank's exhausted
        # heap read as BIG and frontier exhaustion converged with a
        # fake certificate (the single-host r5 bun090 bug, multi-host
        # edition).
        msg[1] = min(self.heap_min_lb(), self._closed_leaf_lb)
        msg[2] = 1.0 if self._locally_idle() else 0.0
        msg[3:12] = np.asarray(self.best_rotation, np.float64).reshape(9)
        msg[12:15] = np.asarray(self.best_translation, np.float64)
        msg[15] = float(len(self._heap))
        # Carried on the wire so the steal payload length is a pure
        # function of the gathered matrix — hosts launched with differing
        # engine configs must still agree on whether/how to enter the
        # second collective, or they deadlock.
        msg[16] = float(max(0, self.engine.multihost_steal_max))
        msg[17] = 0.0   # host mode has no step valve
        return msg

    def _sync_round(self) -> bool:
        """All-gather incumbents; adopt the global best; rebalance work.
        Returns True when the search is globally converged.

        Every decision here is a pure function of the gathered matrix —
        identical on all hosts — so no host can exit the loop while
        another re-enters the collective (that divergence deadlocks)."""
        gathered = self.comm.allgather(self._message(),
                                       timeout=self._round_timeout())
        self.sync_rounds += 1
        k = int(np.argmin(gathered[:, 0]))
        gmin = float(gathered[k, 0])
        if gmin < self.best_sse:
            self.best_sse = gmin
            self.best_rotation = np.asarray(
                gathered[k, 3:12].reshape(3, 3), np.float32)
            self.best_translation = np.asarray(gathered[k, 12:15], np.float32)
            self._record_improvement()
        global_min_lb = float(np.min(gathered[:, 1]))
        # The gap the wire proves: identical on every host.
        self.last_certified_gap = gmin - global_min_lb
        converged = gmin - global_min_lb <= self.sse_threshold
        if not converged:
            # Exhaustion stall: EVERY host idle (locally converged or
            # empty) while closed-leaf floors hold the global gap open.
            # No step can ever change the matrix — locally-converged
            # heaps only hold nodes within their local gap, so stealing
            # them cannot un-idle anyone, and closed leaves cannot be
            # expanded.  Terminate with the gap honestly OPEN rather
            # than livelocking (a pure function of the gathered matrix,
            # so all ranks exit the collective together; the device
            # path's 'stalled' exit uses the same all-idle rule).
            if bool(np.all(gathered[:, 2] > 0.5)):
                log.warning(
                    f"Multi-host search exhausted with an OPEN "
                    f"certificate gap ({self.last_certified_gap:.3g} > "
                    f"{self.sse_threshold:.3g}): closed terminal "
                    f"leaves bound it; result is the best incumbent "
                    f"WITHOUT an optimality certificate")
                return True
            self._maybe_steal(gathered)
        return converged

    def _maybe_steal(self, gathered: np.ndarray) -> None:
        """Move frontier nodes from the largest heap to idle hosts.

        Donor/recipient selection, the decision to run the payload
        collective, AND the payload length are derived from the shared
        matrix (_steal_plan), so either every host enters the second
        all-gather with identical shapes or none does.  Donated nodes
        are popped from the donor (each node lives in exactly one
        heap)."""
        plan = self._steal_plan(gathered)
        if plan is None:
            return
        steal_max, donor, absorbing, n_abs = plan
        payload = np.zeros((1 + 9 * steal_max,), np.float64)
        if self.comm.rank == donor:
            n_give = min(steal_max, len(self._heap) - 1)
            top = heapq.heappop(self._heap)  # donor keeps its best node
            give = [heapq.heappop(self._heap) for _ in range(n_give)]
            heapq.heappush(self._heap, top)
            payload[0] = float(n_give)
            for i, (lb, _, item) in enumerate(give):
                row8 = tuple(item) + (0.0,) * max(0, 8 - len(item))
                payload[1 + 9 * i:10 + 9 * i] = (lb,) + row8
            self.donated_nodes += n_give
        row = self.comm.allgather(payload, timeout=self._timeout)[donor]
        cnt = int(row[0])
        if absorbing[self.comm.rank] and cnt > 0:
            my_idx = int(np.flatnonzero(absorbing).tolist()
                         .index(self.comm.rank))
            for i in range(cnt):
                if i % n_abs != my_idx:
                    continue
                vals = row[1 + 9 * i:10 + 9 * i]
                heapq.heappush(
                    self._heap,
                    (float(vals[0]), next(self._tie),
                     tuple(float(v) for v in vals[1:9])))
                self.stolen_nodes += 1

    def _steal_plan(self, gathered: np.ndarray):
        """The SHARED pure-function core of both steal protocols: decide
        from the gathered matrix alone whether the payload collective
        runs and who participates.  Both modes MUST use this one
        function — a divergence between the two copies of this decision
        is exactly the class of collective deadlock the module doc warns
        about.  Returns (steal_max, donor, absorbing_mask, n_absorbing)
        or None.  `absorbing` excludes hosts idled by the device-mode
        step valve (msg[17]): they vote idle for termination but cannot
        expand donated work — parking live subtrees there would both
        starve the donor and strand the nodes until the stalled
        fallback."""
        steal_max = int(np.min(gathered[:, 16]))
        idle = gathered[:, 2] > 0.5
        absorbing = idle & ~(gathered[:, 17] > 0.5)
        sizes = gathered[:, 15]
        n_abs = int(np.sum(absorbing))
        donor = int(np.argmax(np.where(~idle, sizes, -1.0)))
        if steal_max == 0 or n_abs == 0 or idle[donor] or sizes[donor] < 2:
            return None
        return steal_max, donor, absorbing, n_abs

    # ----- device outer mode: chunked device calls + sync rounds -----
    #
    # Each host seeds its SO3State frontier from its partition cells and
    # runs the WHOLE nested BnB on device in multihost_sync_every-step
    # chunks (one jitted call each, shared executable — max_outer is
    # traced).  Between chunks the same 17-float protocol as host mode
    # synchronizes incumbents: the adopted global best is written INTO
    # the device state, so the next chunk prunes against it.  Work
    # stealing moves frontier rows between states host-side (the state
    # is lb-sorted, so rows 1..n are the donor's next-best nodes).  The
    # staleness bound matches host mode: the incumbent a chunk prunes
    # against is at most sync_every outer steps old.

    def _device_floor_idle(self, st):
        """(certificate_floor, reachable_floor, idle, valve_bound) for
        the wire.  valve_bound = idled by the outer-step safety valve:
        such a host votes idle (termination must still fire) but cannot
        EXPAND anything, so the steal plan must not donate to it."""
        from ..ops import so3_frontier as so3
        reach = float(np.asarray(st.lbs)[0])
        cert = min(reach, float(st.dropped_lb), float(st.closed_lb))
        valve_bound = int(st.outer_steps) >= self._device_valve
        idle = (reach >= float(so3.INVALID)
                or float(st.best_sse) - reach <= self.sse_threshold
                or valve_bound)
        return cert, reach, idle, valve_bound

    def _message_device(self, st) -> np.ndarray:
        from ..ops import so3_frontier as so3
        cert, _, idle, valve_bound = self._device_floor_idle(st)
        msg = np.empty((_MSG_LEN,), np.float64)
        msg[0] = float(st.best_sse)
        msg[1] = cert
        msg[2] = 1.0 if idle else 0.0
        msg[3:12] = np.asarray(st.best_R, np.float64).reshape(9)
        msg[12:15] = np.asarray(st.best_t, np.float64)
        msg[15] = float(np.sum(np.asarray(st.lbs) < float(so3.INVALID)))
        msg[16] = float(max(0, self.engine.multihost_steal_max))
        msg[17] = 1.0 if valve_bound else 0.0
        return msg

    def _sync_round_device(self, st):
        """All-gather incumbents; adopt the global best into the device
        state; rebalance frontier rows.  Returns (status, st) with
        status in {'run', 'converged', 'stalled'} — a pure function of
        the gathered matrix, identical on all hosts ('stalled' = every
        host idle but the certificate gap still open, i.e. capacity
        drops / the step valve; the caller falls back to the host loop
        on all ranks together)."""
        gathered = self.comm.allgather(self._message_device(st),
                                       timeout=self._round_timeout())
        self.sync_rounds += 1
        k = int(np.argmin(gathered[:, 0]))
        gmin = float(gathered[k, 0])
        if gmin < float(st.best_sse):
            st = st._replace(
                best_sse=np.float32(gmin),
                best_R=np.asarray(gathered[k, 3:12].reshape(3, 3),
                                  np.float32),
                best_t=np.asarray(gathered[k, 12:15], np.float32))
        global_min_lb = float(np.min(gathered[:, 1]))
        self.last_certified_gap = gmin - global_min_lb
        if gmin - global_min_lb <= self.sse_threshold:
            return "converged", st
        if bool(np.all(gathered[:, 2] > 0.5)):
            return "stalled", st
        st = self._maybe_steal_device(gathered, st)
        return "run", st

    def _maybe_steal_device(self, gathered: np.ndarray, st):
        """Host-mode _maybe_steal, operating on lb-sorted SO3State rows
        instead of a heap.  The steal decision itself comes from the
        SHARED _steal_plan (same pure-function collective contract)."""
        from ..ops import so3_frontier as so3
        plan = self._steal_plan(gathered)
        if plan is None:
            return st
        steal_max, donor, absorbing, n_abs = plan
        payload = np.zeros((1 + 9 * steal_max,), np.float64)
        if self.comm.rank == donor:
            lbs = np.asarray(st.lbs).copy()
            ubs = np.asarray(st.ubs).copy()
            coords = np.asarray(st.coords).copy()
            spans = np.asarray(st.spans).copy()
            ts = np.asarray(st.ts).copy()
            n_valid = int(np.sum(lbs < float(so3.INVALID)))
            n_give = min(steal_max, n_valid - 1)
            payload[0] = float(n_give)
            for i in range(n_give):
                r = 1 + i   # row 0 = donor's best node, kept
                payload[1 + 9 * i:10 + 9 * i] = (
                    lbs[r], coords[r, 0], coords[r, 1], coords[r, 2],
                    spans[r], ubs[r], ts[r, 0], ts[r, 1], ts[r, 2])
            lbs[1:1 + n_give] = float(so3.INVALID)
            ubs[1:1 + n_give] = float(so3.BIG)
            spans[1:1 + n_give] = 0.0
            order = np.argsort(lbs, kind="stable")
            st = st._replace(lbs=lbs[order], ubs=ubs[order],
                             coords=coords[order], spans=spans[order],
                             ts=ts[order])
            self.donated_nodes += n_give
        row = self.comm.allgather(payload, timeout=self._timeout)[donor]
        cnt = int(row[0])
        if absorbing[self.comm.rank] and cnt > 0:
            my_idx = int(np.flatnonzero(absorbing).tolist()
                         .index(self.comm.rank))
            take = [row[1 + 9 * i:10 + 9 * i]
                    for i in range(cnt) if i % n_abs == my_idx]
            if take:
                lbs = np.concatenate(
                    [np.asarray(st.lbs),
                     np.asarray([n[0] for n in take], np.float32)])
                ubs = np.concatenate(
                    [np.asarray(st.ubs),
                     np.asarray([n[5] for n in take], np.float32)])
                coords = np.concatenate(
                    [np.asarray(st.coords),
                     np.asarray([n[1:4] for n in take], np.float32)])
                spans = np.concatenate(
                    [np.asarray(st.spans),
                     np.asarray([n[4] for n in take], np.float32)])
                ts = np.concatenate(
                    [np.asarray(st.ts),
                     np.asarray([n[6:9] for n in take], np.float32)])
                cap = np.asarray(st.lbs).shape[0]
                order = np.argsort(lbs, kind="stable")
                dropped_lb = float(st.dropped_lb)
                if len(order) > cap:
                    spill = lbs[order[cap:]]
                    spill = spill[spill < float(so3.INVALID)]
                    if spill.size:   # capacity overflow: certificate clamp
                        dropped_lb = min(dropped_lb, float(spill.min()))
                order = order[:cap]
                st = st._replace(
                    lbs=lbs[order], ubs=ubs[order], coords=coords[order],
                    spans=spans[order], ts=ts[order],
                    dropped_lb=np.float32(dropped_lb))
                self.stolen_nodes += len(take)
        return st

    def _bnb_so3_device_multihost(self) -> bool:
        """Partitioned device-outer search; returns True when it ended
        with an OPEN certificate (all hosts stalled on drops/valve) and
        the caller must re-certify with the host loop."""
        from ..ops import so3_frontier as so3
        e = self.engine
        call = self._device_call_fn()
        st = self._resumed_so3_state
        self._resumed_so3_state = None
        if st is None:
            st = so3.initial_state(
                e.so3_capacity, best_sse=self.best_sse,
                best_R=self.best_rotation, best_t=self.best_translation,
                cells=self.root_nodes())
        last = {f: int(getattr(st, f)) for f in self._DEVICE_COUNTERS}
        hist_seen = int(st.hist_len)
        # Relative step valve (goicp._bnb_so3_device rationale): elastic
        # recovery SUMS outer_steps when merging crash checkpoints, so an
        # absolute cap could start exhausted and idle the host forever.
        self._device_valve = int(st.outer_steps) + self._DEVICE_MAX_OUTER
        last_ckpt_steps = int(st.outer_steps)
        sync_every = max(1, e.multihost_sync_every)
        status = "run"
        while True:
            status, st = self._sync_round_device(st)
            if status != "run":
                break
            _, _, idle, _ = self._device_floor_idle(st)
            if idle:
                self.idle_rounds += 1
                continue
            cap = min(int(st.outer_steps) + sync_every, self._device_valve)
            # ONE fetch per chunk: the sync/steal protocol reads ~20
            # state fields host-side, each its own blocking device->host
            # round trip on a device pytree (goicp._bnb_so3_device doc).
            st = jax.device_get(call(st, cap))
            self._sanitize_device_state(st)
            self._flush_device_counters(st, last)
            # Honor the configured cadence ('outer steps between
            # checkpoints') — one .npz per sync round at sync_every=1
            # would be 100x the configured IO at checkpoint_every=100.
            if e.checkpoint_path and e.checkpoint_every > 0 and \
                    int(st.outer_steps) - last_ckpt_steps >= \
                    e.checkpoint_every:
                self._save_device_checkpoint(st)
                last_ckpt_steps = int(st.outer_steps)
        self._device_adopt(st, hist_seen, last)
        log.debug(f"[host {self.comm.rank}] device BnB {status}: "
                  f"{self.sync_rounds} sync rounds, {self.idle_rounds} "
                  f"idle, {self.donated_nodes} donated / "
                  f"{self.stolen_nodes} stolen, best={self.best_sse}")
        return status == "stalled"

    def _branch_and_bound_so3(self):
        if self.engine.outer_mode == "device":
            open_cert = self._bnb_so3_device_multihost()
            if not open_cert:
                return self.best_sse
            log.warning(
                "Multi-host device SO(3) search stalled with an open "
                "certificate gap (frontier drops or the step valve) — "
                "re-certifying with the partitioned host loop (raise "
                "engine.so3_capacity to avoid this)")
        self.seed_heap()
        sync_every = max(1, self.engine.multihost_sync_every)
        while True:
            if self._sync_round():
                break
            stepped = False
            for _ in range(sync_every):
                if self._heap and not self.outer_converged():
                    self.outer_step()
                    stepped = True
                else:
                    break
            if not stepped:
                self.idle_rounds += 1
        log.debug(f"[host {self.comm.rank}] BnB done: "
                  f"{self.sync_rounds} sync rounds, "
                  f"{self.idle_rounds} idle, "
                  f"{self.donated_nodes} donated / {self.stolen_nodes} "
                  f"stolen nodes, best={self.best_sse}")
        return self.best_sse


def register_multihost(pct, pcs, comm=None, lut_resolution: float = 0.005,
                       mse_threshold: float = 1e-3,
                       engine: Optional[EngineConfig] = None, **kw):
    """Convenience entry: initialize (if needed) and run multi-host Go-ICP."""
    if comm is None:
        comm = JaxProcessCommunicator()
    model = MultiHostGoICP(pct, pcs, comm, lut_resolution=lut_resolution,
                           mse_threshold=mse_threshold, engine=engine, **kw)
    R, t = model.run()
    return model, R, t
