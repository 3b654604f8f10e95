"""Deterministic, config-scheduled fault injection (own copy of
``repro/resilience/inject.py``).

A :class:`FaultSchedule` is a list of :class:`FaultSpec` entries, each
pinning one fault to an exact ``(epoch, step, rank)``.  Every minibatch
is a pure function of ``(base_seed, epoch, step)``, so replaying a
schedule against the same config reproduces the same chaos run bit for
bit.  ``FaultSchedule.sample`` draws a schedule from a seed; the result
is a plain spec list, so a failing sweep replays from its seed alone.

Fault kinds:

``nan_step``        the rank's layer-0 activations times NaN for that
                    step (the NaN/Inf step guard must skip it).
``drop_push``       the rank's outgoing AEP push is dropped on the wire
                    (tags -1, embeddings zeroed).
``corrupt_push``    the rank's outgoing AEP push arrives as NaN, tags
                    intact, so the garbage lands in remote HEC lines.
``delay_rank``      a host sleep of ``seconds`` before the step.
``kill_prefetch``   the prefetch worker drawing that ``(epoch, step)``
                    raises on its first attempt (the one retry then
                    draws the same batch).

The first three are device faults: they reach the step as a per-rank
int32 bitmask (``step_codes``); an all-zero mask computes the unarmed
step's bits.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import List, Optional, Sequence

import numpy as np

KINDS = ("nan_step", "drop_push", "corrupt_push", "delay_rank",
         "kill_prefetch")

# device-fault bits, OR-ed into the per-rank fault code of a step
CODE_NAN_STEP = 1
CODE_DROP_PUSH = 2
CODE_CORRUPT_PUSH = 4
_CODE = {"nan_step": CODE_NAN_STEP, "drop_push": CODE_DROP_PUSH,
         "corrupt_push": CODE_CORRUPT_PUSH}


class PrefetchWorkerKilled(RuntimeError):
    """Raised inside a prefetch worker by a ``kill_prefetch`` fault."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    kind: str
    epoch: int
    step: int
    rank: int = 0
    seconds: float = 0.05  # delay_rank only

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")

    def to_dict(self) -> dict:
        d = {"kind": self.kind, "epoch": self.epoch, "step": self.step,
             "rank": self.rank}
        if self.kind == "delay_rank":
            d["seconds"] = self.seconds
        return d


class FaultSchedule:
    """An ordered, immutable set of scheduled faults."""

    def __init__(self, specs: Sequence[FaultSpec]):
        self.specs = tuple(specs)
        self._by_es = {}
        for s in self.specs:
            self._by_es.setdefault((s.epoch, s.step), []).append(s)

    def __len__(self):
        return len(self.specs)

    def faults_at(self, epoch: int, step: int) -> List[FaultSpec]:
        return self._by_es.get((epoch, step), [])

    @property
    def has_device_faults(self) -> bool:
        return any(s.kind in _CODE for s in self.specs)

    def to_dicts(self) -> List[dict]:
        return [s.to_dict() for s in self.specs]

    @classmethod
    def from_dicts(cls, dicts: Sequence[dict]) -> "FaultSchedule":
        return cls([FaultSpec(**d) for d in dicts])

    @classmethod
    def from_json(cls, path: str) -> "FaultSchedule":
        with open(path) as f:
            return cls.from_dicts(json.load(f))

    @classmethod
    def sample(cls, n: int, num_epochs: int, steps_per_epoch: int,
               num_ranks: int, seed: int = 0,
               kinds: Sequence[str] = KINDS) -> "FaultSchedule":
        """Draw ``n`` random faults deterministically from ``seed``."""
        rng = np.random.default_rng([seed, 0xFA17])
        return cls([FaultSpec(kind=str(rng.choice(list(kinds))),
                              epoch=int(rng.integers(num_epochs)),
                              step=int(rng.integers(steps_per_epoch)),
                              rank=int(rng.integers(num_ranks)))
                    for _ in range(n)])


class FaultInjector:
    """Executes a :class:`FaultSchedule` and logs every firing.

    ``step_codes`` is called once per training step: it returns the
    per-rank device-fault bitmask and performs the ``delay_rank`` sleeps.
    ``prefetch_crash`` is called by the sampling plan inside the prefetch
    worker; a matching ``kill_prefetch`` spec raises exactly once.
    """

    def __init__(self, schedule: Optional[FaultSchedule] = None):
        self.schedule = schedule or FaultSchedule([])
        self.events: List[dict] = []
        self._prefetch_fired = set()

    def _record(self, spec: FaultSpec) -> None:
        self.events.append(spec.to_dict())

    def step_codes(self, epoch: int, step: int,
                   num_ranks: int) -> np.ndarray:
        codes = np.zeros((num_ranks,), np.int32)
        for spec in self.schedule.faults_at(epoch, step):
            if spec.kind in _CODE:
                codes[spec.rank % num_ranks] |= _CODE[spec.kind]
                self._record(spec)
            elif spec.kind == "delay_rank":
                time.sleep(spec.seconds)
                self._record(spec)
        return codes

    def prefetch_crash(self, epoch: int, step: int) -> None:
        for spec in self.schedule.faults_at(epoch, step):
            if spec.kind != "kill_prefetch":
                continue
            key = (spec.epoch, spec.step, spec.rank)
            if key in self._prefetch_fired:
                continue
            self._prefetch_fired.add(key)
            self._record(spec)
            raise PrefetchWorkerKilled(
                f"injected worker crash at epoch={epoch} step={step}")
