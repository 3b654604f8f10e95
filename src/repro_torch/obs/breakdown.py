"""Paper-style epoch breakdown (own copy of ``repro/obs/breakdown.py``):
how much of an epoch is minibatch sampling, host preparation, H2D
staging, forward, AEP push and backward, and how much of the push is
hidden behind the backward.

The host phases (sample / host_prep / stage) come from the span timers.
The ``step`` span is split into forward / exposed push / backward by a
:class:`StepModel`: the default 1:2 forward:backward work ratio, or a
roofline model (``StepModel.from_roofline``).  The **overlap
efficiency**, ``min(push, backward) / push``, is the model's; the
measured share of push-stream device time that overlaps main-stream
kernels comes from the device trace (``obs/device_trace.py``).

Shares in every row sum to 1.0 (shares of summed phase time; with the
pipeline the host phases overlap the step, so summed phase time exceeds
the wall clock, and that surplus is ``pipeline_overlap``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

# phase keys as accumulated by the span timers (host-measured) ...
MEASURED_PHASES = ("sample", "host_prep", "stage", "step")
# ... and as reported in the breakdown table (step split by the model)
REPORT_PHASES = ("sample", "host_prep", "h2d", "fwd", "aep_push", "bwd")


@dataclasses.dataclass(frozen=True)
class StepModel:
    """Decomposition model of one train step.

    ``work_s`` — modeled device work (the larger of the compute and
    memory roofline times), ``push_s`` — modeled AEP all_to_all latency,
    ``fwd_frac`` — forward share of the work (default 1/3, the 1:2
    forward:backward ratio).  All zeros (the default) means no model:
    ``split_step`` uses the bare ratio with no exposed push, and
    ``overlap_efficiency`` reports 1.0 (nothing to hide)."""
    work_s: float = 0.0
    push_s: float = 0.0
    fwd_frac: float = 1.0 / 3.0

    @classmethod
    def from_roofline(cls, flops: float, bytes_accessed: float,
                      push_bytes: float, peak_flops: float, hbm_bw: float,
                      ici_bw: float, fwd_frac: float = 1.0 / 3.0
                      ) -> "StepModel":
        """From a step's operation and byte counts and the device's rates
        (``ici_bw``: the link that carries the push)."""
        work = max(flops / peak_flops, bytes_accessed / hbm_bw)
        return cls(work_s=work, push_s=push_bytes / ici_bw,
                   fwd_frac=fwd_frac)

    @property
    def fwd_s(self) -> float:
        return self.work_s * self.fwd_frac

    @property
    def bwd_s(self) -> float:
        return self.work_s * (1.0 - self.fwd_frac)

    @property
    def exposed_push_s(self) -> float:
        """Push latency NOT hidden behind the backward pass."""
        return max(0.0, self.push_s - self.bwd_s)

    @property
    def step_s(self) -> float:
        """Modeled wall time of one step: fwd + bwd + exposed push."""
        return self.fwd_s + self.bwd_s + self.exposed_push_s

    def overlap_efficiency(self) -> float:
        """Fraction of the modeled push latency hidden behind backward
        compute; 1.0 when there is no push to hide."""
        if self.push_s <= 0.0:
            return 1.0
        return min(self.push_s, self.bwd_s) / self.push_s

    def split_step(self, t_step: float):
        """Attribute a *measured* step wall time to (fwd, exposed push,
        bwd), scaled so the three parts sum to ``t_step`` exactly."""
        total = self.step_s
        if total <= 0.0:
            return (t_step * self.fwd_frac, 0.0,
                    t_step * (1.0 - self.fwd_frac))
        s = t_step / total
        return self.fwd_s * s, self.exposed_push_s * s, self.bwd_s * s


class EpochBreakdown:
    """Accumulates per-epoch phase seconds; renders the paper-style table."""

    def __init__(self, model: Optional[StepModel] = None):
        self.model = model or StepModel()
        self.epochs: List[dict] = []

    def add_epoch(self, sample: float = 0.0, host_prep: float = 0.0,
                  stage: float = 0.0, step: float = 0.0,
                  wall: Optional[float] = None):
        self.epochs.append({"sample": sample, "host_prep": host_prep,
                            "stage": stage, "step": step, "wall": wall})

    @classmethod
    def from_history(cls, history: Sequence[dict],
                     model: Optional[StepModel] = None) -> "EpochBreakdown":
        """From ``DistTrainer.train_epochs`` history rows (their
        ``t_<phase>`` keys)."""
        bd = cls(model)
        for row in history:
            bd.add_epoch(sample=row.get("t_sample", 0.0),
                         host_prep=row.get("t_host_prep", 0.0),
                         stage=row.get("t_stage", 0.0),
                         step=row.get("t_step", 0.0),
                         wall=row.get("t_wall"))
        return bd

    def rows(self) -> List[dict]:
        """One dict per epoch: ``share_<phase>`` over REPORT_PHASES
        (summing to 1.0), ``total_s``, ``wall_s``, the modeled
        ``overlap_efficiency`` and ``pipeline_overlap`` (the summed phase
        time's surplus over the wall clock)."""
        out = []
        eff = self.model.overlap_efficiency()
        for ep in self.epochs:
            fwd, push, bwd = self.model.split_step(ep["step"])
            parts = {"sample": ep["sample"], "host_prep": ep["host_prep"],
                     "h2d": ep["stage"], "fwd": fwd, "aep_push": push,
                     "bwd": bwd}
            total = sum(parts.values())
            row = {f"share_{k}": (v / total if total > 0.0 else 0.0)
                   for k, v in parts.items()}
            row["total_s"] = total
            row["overlap_efficiency"] = eff
            if ep["wall"]:
                row["wall_s"] = ep["wall"]
                row["pipeline_overlap"] = max(0.0, total - ep["wall"]) \
                    / total if total > 0.0 else 0.0
            out.append(row)
        return out

    def table(self) -> str:
        """The printable per-epoch breakdown (shares as percentages)."""
        header = ["epoch"] + list(REPORT_PHASES) + ["total_s", "overlap_eff"]
        lines = ["  ".join(f"{h:>10s}" for h in header)]
        for i, row in enumerate(self.rows()):
            cells = [f"{i:>10d}"]
            cells += [f"{row[f'share_{p}'] * 100:>9.1f}%"
                      for p in REPORT_PHASES]
            cells.append(f"{row['total_s']:>10.3f}")
            cells.append(f"{row['overlap_efficiency'] * 100:>10.0f}%")
            lines.append("  ".join(cells))
        return "\n".join(lines)
