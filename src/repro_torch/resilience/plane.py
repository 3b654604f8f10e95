"""ResiliencePlane: the host-side coordinator the trainer talks to (own
copy of ``repro/resilience/plane.py``).

It owns the :class:`FaultInjector` (when a schedule is armed), the
:class:`CheckpointManager` (when ``ckpt_dir`` is set) and the count of
steps the NaN/Inf guard skipped.  When a fault fired or a step was
skipped, ``finalize`` notes the event log into the health plane's flight
recorder (or a private one when no health plane is wired) and dumps
``FLIGHT_resilience.json``.

Every knob is off by default; a plane that is neither step-armed nor
checkpointing changes nothing: the trainer runs the unarmed step.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch import obs
from repro_torch.resilience.checkpoint import CheckpointManager
from repro_torch.resilience.inject import FaultInjector, FaultSchedule


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    ckpt_dir: Optional[str] = None   # epoch-boundary checkpoints when set
    ckpt_every: int = 1              # save every k-th epoch boundary
    ckpt_keep: int = 3               # keep the newest k archives
    nan_guard: bool = False          # skip non-finite steps
    schedule: Optional[FaultSchedule] = None  # scheduled fault injection
    flight_dir: str = "."            # FLIGHT_resilience.json without health


class ResiliencePlane:
    def __init__(self, cfg: Optional[ResilienceConfig] = None):
        self.cfg = cfg or ResilienceConfig()
        self.ckpt = (CheckpointManager(self.cfg.ckpt_dir,
                                       every=self.cfg.ckpt_every,
                                       keep=self.cfg.ckpt_keep)
                     if self.cfg.ckpt_dir else None)
        self.injector = (FaultInjector(self.cfg.schedule)
                         if self.cfg.schedule is not None else None)
        self.skipped_steps = 0
        self.flight_paths: List[str] = []

    @property
    def step_armed(self) -> bool:
        """True when the step takes fault codes and runs the guard."""
        return self.cfg.nan_guard or self.injector is not None

    @property
    def events(self) -> List[dict]:
        return self.injector.events if self.injector else []

    def step_codes(self, epoch: int, step: int,
                   num_ranks: int) -> np.ndarray:
        if self.injector is None:
            return np.zeros((num_ranks,), np.int32)
        return self.injector.step_codes(epoch, step, num_ranks)

    def on_step(self, epoch: int, step: int, skipped: float) -> None:
        if skipped > 0:
            self.skipped_steps += 1
            obs.count("resilience_skipped_steps")
            obs.get().registry.log_event(
                "resilience_skip", epoch=int(epoch), step=int(step))

    def maybe_checkpoint(self, state: dict, epoch: int) -> Optional[str]:
        if self.ckpt is None or not self.ckpt.should_save(epoch):
            return None
        return self.ckpt.save(state, epoch)

    def finalize(self, health=None) -> Optional[str]:
        """Dump ``FLIGHT_resilience.json`` if anything fired this run."""
        if not self.events and self.skipped_steps == 0:
            return None
        obs.set_gauge("resilience_faults_injected", float(len(self.events)))
        extra = {"faults": self.events,
                 "skipped_steps": self.skipped_steps}
        if health is not None:
            recorder, out_dir = health.recorder, health.cfg.flight_dir
        else:
            recorder, out_dir = obs.FlightRecorder(), self.cfg.flight_dir
        recorder.note("resilience", **extra)
        path = recorder.dump("resilience", out_dir, extra=extra)
        self.flight_paths.append(path)
        if health is not None:
            health.flight_paths.append(path)
        return path
