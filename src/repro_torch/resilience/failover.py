"""Per-rank health mask with a circuit breaker, for degraded serving (own
copy of ``repro/resilience/failover.py``).

A three-state breaker per rank:

* ``CLOSED`` — healthy; halo traffic and query routing flow normally.
* ``OPEN`` — marked dead (``record_failure`` reached ``threshold``, or
  ``force_open``).  The serve scheduler suppresses halo requests to the
  rank, masks its responder side and answers its owned queries from
  stale replicas.  It stays open for ``cooldown`` rounds.
* ``HALF_OPEN`` — the cooldown has elapsed; the next ``tick`` runs the
  probe with a timeout (a hung probe counts as dead).  Success closes
  the breaker; failure opens it for another cooldown.

``tick`` is called once per serve round with the round index, so the
cooldown is counted in rounds: no wall clock but the probe's timeout.
"""
from __future__ import annotations

import threading
from typing import Callable, List, Optional

import numpy as np

CLOSED, OPEN, HALF_OPEN = 0, 1, 2


def probe_with_timeout(fn: Callable[[int], bool], rank: int,
                       timeout_s: float) -> bool:
    """Run ``fn(rank)`` in a side thread; a hang, an exception or
    ``False`` all mean dead."""
    out = {"ok": False}

    def _run():
        try:
            out["ok"] = bool(fn(rank))
        except Exception:
            out["ok"] = False

    t = threading.Thread(target=_run, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        return False                    # timed out: the rank stays dead
    return out["ok"]


class RankHealthMask:
    def __init__(self, num_ranks: int, cooldown: int = 1,
                 threshold: int = 1):
        self.num_ranks = num_ranks
        self.cooldown = max(0, cooldown)
        self.threshold = max(1, threshold)
        self.state = np.full((num_ranks,), CLOSED, np.int32)
        self.opened_at = np.zeros((num_ranks,), np.int64)
        self.failures = np.zeros((num_ranks,), np.int64)

    @property
    def alive(self) -> np.ndarray:
        return self.state == CLOSED

    @property
    def dead_ranks(self) -> List[int]:
        return [int(r) for r in np.nonzero(self.state != CLOSED)[0]]

    @property
    def any_dead(self) -> bool:
        return bool((self.state != CLOSED).any())

    def record_failure(self, rank: int, round_idx: int) -> bool:
        """Count a failure; returns True if the breaker just opened."""
        if self.state[rank] != CLOSED:
            return False
        self.failures[rank] += 1
        if self.failures[rank] >= self.threshold:
            self.force_open(rank, round_idx)
            return True
        return False

    def force_open(self, rank: int, round_idx: int) -> None:
        self.state[rank] = OPEN
        self.opened_at[rank] = round_idx
        self.failures[rank] = 0

    def record_success(self, rank: int) -> None:
        self.state[rank] = CLOSED
        self.failures[rank] = 0

    def tick(self, round_idx: int,
             probe: Optional[Callable[[int], bool]] = None,
             timeout_s: float = 1.0) -> List[int]:
        """Advance the breakers; returns the ranks that just recovered.
        ``probe=None`` succeeds: an open rank recovers as soon as its
        cooldown has elapsed."""
        recovered = []
        for r in range(self.num_ranks):
            if self.state[r] == CLOSED:
                continue
            if round_idx - self.opened_at[r] < self.cooldown:
                continue
            self.state[r] = HALF_OPEN
            ok = True if probe is None else probe_with_timeout(
                probe, r, timeout_s)
            if ok:
                self.record_success(r)
                recovered.append(r)
            else:
                self.force_open(r, round_idx)   # a fresh cooldown
        return recovered
