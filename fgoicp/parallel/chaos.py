"""Race/chaos harness for the multi-host collective protocol.

The reference ships no race detection or sanitizers (SURVEY §5: no
compute-sanitizer targets, no TSAN/ASAN; its only cross-stream hazard
handling is a final cudaDeviceSynchronize).  This repo's equivalent
hazard surface is the multi-host BnB protocol (parallel/distributed.py):
every termination / incumbent-adoption / work-stealing decision must be
a PURE FUNCTION of the all-gathered matrix, or hosts diverge — one exits
the loop while another re-enters the collective, which deadlocks.  That
property cannot be type-checked; it can be fuzzed.

`ChaosCommunicator` wraps any communicator and injects seeded,
per-rank-decorrelated scheduling jitter around every collective —
modeling slow hosts, OS preemption, and network latency skew — while
recording a digest of every gathered matrix.  `verify_agreement` then
asserts the protocol invariants that a race would break:

  * **Lockstep**: all ranks executed the SAME number of collectives
    (a diverged rank calls one more or one fewer — the deadlock shape).
  * **Agreement**: round r's gathered matrix is bit-identical on every
    rank (the pure-function property's precondition; the jax wire
    guarantees it, the ThreadCommunicator double must too).
  * **Conservation** (work stealing): every donated frontier node is
    absorbed exactly once — sum(donated) == sum(stolen) — so no subtree
    is duplicated (wasted work) or lost (a VOIDED certificate).

tests/test_chaos.py sweeps seeds x outer modes x imbalanced partitions;
any scheduling-dependent divergence surfaces as a broken invariant or a
barrier timeout instead of a silent wrong answer.
"""

from __future__ import annotations

import hashlib
import time
from typing import Optional, Sequence

import numpy as np


class ChaosCommunicator:
    """Communicator wrapper: seeded random delays + gather digests.

    delay_s: max one-sided delay injected before AND after the inner
    collective (uniform in [0, delay_s], per rank per round,
    decorrelated by (seed, rank)).  The delays stretch the window in
    which a protocol divergence can interleave; the barrier semantics of
    the inner communicator are untouched.
    """

    def __init__(self, inner, seed: int = 0, delay_s: float = 0.002):
        self.inner = inner
        self.rank = inner.rank
        self.size = inner.size
        self.delay_s = float(delay_s)
        self._rng = np.random.default_rng(
            np.random.SeedSequence(entropy=seed, spawn_key=(inner.rank,)))
        self.digests: list[bytes] = []   # one per allgather, in order

    @classmethod
    def wrap_all(cls, comms: Sequence, seed: int = 0,
                 delay_s: float = 0.002) -> list["ChaosCommunicator"]:
        return [cls(c, seed=seed, delay_s=delay_s) for c in comms]

    def _jitter(self):
        if self.delay_s > 0:
            time.sleep(float(self._rng.uniform(0.0, self.delay_s)))

    def allgather(self, vec: np.ndarray,
                  timeout: Optional[float] = None) -> np.ndarray:
        self._jitter()
        out = self.inner.allgather(vec, timeout=timeout)
        self.digests.append(
            hashlib.sha256(np.ascontiguousarray(
                np.asarray(out, np.float64)).tobytes()).digest())
        self._jitter()
        return out


def verify_agreement(comms: Sequence[ChaosCommunicator]) -> int:
    """Assert the lockstep + agreement invariants over a finished run;
    returns the number of collective rounds verified."""
    rounds = {len(c.digests) for c in comms}
    if len(rounds) != 1:
        raise AssertionError(
            f"protocol divergence: ranks executed differing collective "
            f"counts {sorted(len(c.digests) for c in comms)}")
    (n,) = rounds
    for r in range(n):
        seen = {c.digests[r] for c in comms}
        if len(seen) != 1:
            raise AssertionError(
                f"protocol divergence: round {r} gathered matrices "
                f"differ across ranks")
    return n


def verify_conservation(models: Sequence) -> None:
    """Assert the work-stealing conservation invariant over finished
    MultiHostGoICP models: every donated node absorbed exactly once."""
    donated = sum(m.donated_nodes for m in models)
    stolen = sum(m.stolen_nodes for m in models)
    if donated != stolen:
        raise AssertionError(
            f"work-stealing conservation violated: {donated} donated != "
            f"{stolen} stolen")
