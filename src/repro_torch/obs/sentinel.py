"""Anomaly flight recorder and the HealthPlane that ties the cluster
health layer together (own copy of ``repro/obs/sentinel.py``).

:class:`FlightRecorder` keeps a bounded ring buffer of recent events
(epoch summaries, metric deltas, detections, exceptions).  When a
detector fires or an exception escapes a guarded step loop it dumps the
whole buffer as a self-contained ``FLIGHT_<reason>.json``.

:class:`HealthPlane` is the per-process coordinator the trainer, both
serve schedulers and the three GNN launchers wire in: it owns the
detectors (:mod:`repro_torch.obs.detect`), feeds them each epoch or
round from the :class:`~repro_torch.obs.cluster.RankAccumulator`
totals, publishes detector gauges into the registry, records everything
into the flight recorder, and exposes ``guard()`` — the context manager
that turns an escaping exception into a flight dump before re-raising.

Everything here is host-side bookkeeping: the step's outputs are the
same bits with the plane off or on (``tests/test_torch_health.py``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import time
import traceback
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional

import numpy as np

from repro_torch.obs import cluster, detect
from repro_torch.obs.registry import Histogram, MetricsRegistry

_MAX_DELTA_KEYS = 64            # bound per-entry metric-delta payloads


def _slug(reason: str) -> str:
    return re.sub(r"[^A-Za-z0-9_-]+", "_", reason).strip("_")[:80] or "event"


class FlightRecorder:
    """Bounded ring buffer of recent health-plane events.

    ``note`` appends one entry (old entries fall off the end — the
    buffer, and therefore every dump, is bounded by ``capacity``);
    ``dump`` writes the buffer as ``FLIGHT_<reason>.json``.  Repeated
    dumps with the same reason overwrite (a sustained anomaly produces
    one file, not a flood)."""

    def __init__(self, capacity: int = 256):
        self.capacity = int(capacity)
        self.entries: deque = deque(maxlen=self.capacity)
        self._seq = 0
        self._t0 = time.perf_counter()
        self._last_snapshot: Dict[str, float] = {}

    def note(self, kind: str, **payload):
        self._seq += 1
        self.entries.append({
            "seq": self._seq, "kind": kind,
            "t_s": round(time.perf_counter() - self._t0, 6), **payload})

    def record_metrics_delta(self, reg: MetricsRegistry):
        """Append the changed-metric delta since the previous call
        (bounded to the largest ``_MAX_DELTA_KEYS`` moves)."""
        snap = reg.snapshot()
        delta = {k: v - self._last_snapshot.get(k, 0.0)
                 for k, v in snap.items()
                 if v != self._last_snapshot.get(k, 0.0)}
        self._last_snapshot = snap
        if not delta:
            return
        top = sorted(delta, key=lambda k: abs(delta[k]), reverse=True)
        self.note("metrics_delta",
                  changed={k: round(float(delta[k]), 6)
                           for k in sorted(top[:_MAX_DELTA_KEYS])},
                  dropped=max(0, len(delta) - _MAX_DELTA_KEYS))

    def dump(self, reason: str, out_dir: str = ".",
             extra: Optional[dict] = None) -> str:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"FLIGHT_{_slug(reason)}.json")
        payload = {
            "reason": reason,
            "created_unix": time.time(),
            "capacity": self.capacity,
            "num_entries": len(self.entries),
            "entries": list(self.entries),
        }
        if extra:
            payload.update(extra)
        with open(path, "w") as f:
            json.dump(payload, f, indent=1, default=str)
        return path


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Knobs for one :class:`HealthPlane` (defaults are deliberately
    conservative — windowed persistence everywhere, see
    :mod:`repro_torch.obs.detect` for each detector's semantics)."""
    enabled: bool = True
    flight_dir: str = "."
    flight_capacity: int = 256
    dump_on_detection: bool = True
    # straggler: rank step-time > k * median for `window` epochs
    straggler_k: float = 2.0
    straggler_window: int = 3
    # load skew: max/mean of `skew_metric` > threshold for `window`
    skew_metric: str = "rank_halo_rows"
    skew_threshold: float = 4.0
    skew_window: int = 3
    # edge-cut drift vs plan expectation (needs expected_halo_rows)
    drift_tolerance: float = 0.25
    drift_window: int = 3
    # serve SLO burn (active only when a p99 target is set)
    slo_p99_s: Optional[float] = None
    slo_burn_threshold: float = 0.05
    slo_window: int = 2
    slo_min_samples: int = 20
    # hot-tier efficacy decay (re-seed signal)
    hot_metric: str = "rank_hot_hits"
    hot_decay: float = 0.5
    hot_window: int = 3
    # embedding-quality budget (active only when a budget is set; fed by
    # the quality plane's exactness audit via `observe_audit`)
    quality_budget: Optional[float] = None
    quality_window: int = 2


class HealthPlane:
    """Detectors + flight recorder behind one epoch/round entry point.

    Call :meth:`observe_epoch` (trainer) or :meth:`observe_round`
    (serve) once per window with the :class:`RankAccumulator` totals;
    wrap step loops in :meth:`guard`.  ``expected_halo_rows`` (e.g.
    ``ExchangePlan.expected_inbound_rows()``) arms the edge-cut-drift
    detector; ``cfg.slo_p99_s`` arms SLO burn."""

    def __init__(self, cfg: Optional[HealthConfig] = None,
                 num_ranks: int = 1,
                 expected_halo_rows=None,
                 registry: Optional[MetricsRegistry] = None):
        self.cfg = cfg or HealthConfig()
        self.enabled = self.cfg.enabled
        self.num_ranks = int(num_ranks)
        self._registry = registry
        self.recorder = FlightRecorder(self.cfg.flight_capacity)
        c = self.cfg
        self.straggler = detect.StragglerDetector(c.straggler_k,
                                                  c.straggler_window)
        self.skew = detect.LoadSkewDetector(c.skew_threshold, c.skew_window,
                                            metric=c.skew_metric)
        self.drift = None
        if expected_halo_rows is not None:
            exp = np.asarray(expected_halo_rows, np.float64).reshape(-1)
            if exp.size and exp.sum() > 0:
                self.drift = detect.EdgeCutDriftDetector(
                    exp, c.drift_tolerance, c.drift_window)
        self.slo = None
        if c.slo_p99_s is not None:
            self.slo = detect.SLOBurnDetector(
                c.slo_p99_s, c.slo_burn_threshold, c.slo_window,
                c.slo_min_samples)
        self.hot_decay = detect.HotTierDecayDetector(c.hot_decay,
                                                     c.hot_window)
        self.quality = None
        if c.quality_budget is not None:
            self.quality = detect.QualityBudgetDetector(c.quality_budget,
                                                        c.quality_window)
        self.detections: List[detect.Detection] = []
        self.flight_paths: List[str] = []
        self._window = 0

    # -- plumbing -------------------------------------------------------------
    def _reg(self) -> MetricsRegistry:
        if self._registry is not None:
            return self._registry
        from repro_torch import obs    # deferred: obs/__init__ imports us
        return obs.get().registry

    def new_accumulator(self) -> cluster.RankAccumulator:
        return cluster.RankAccumulator(self.num_ranks)

    # -- window entry points --------------------------------------------------
    def observe_epoch(self, totals: Dict[str, np.ndarray],
                      epoch: Optional[int] = None,
                      step_s_per_rank=None,
                      wall_s: Optional[float] = None,
                      latency_hist: Optional[Histogram] = None,
                      ) -> List[detect.Detection]:
        """Feed one window of per-rank totals through every armed
        detector.  Returns (and records) the new detections."""
        if not self.enabled:
            return []
        epoch = self._window if epoch is None else int(epoch)
        self._window = epoch + 1
        reg = self._reg()
        self.recorder.note(
            "window", epoch=epoch, wall_s=wall_s,
            totals={k: [round(float(x), 4) for x in np.asarray(v).reshape(-1)]
                    for k, v in sorted(totals.items())})
        if reg.enabled:
            self.recorder.record_metrics_delta(reg)

        new: List[detect.Detection] = []
        if step_s_per_rank is None:
            step_s_per_rank = totals.get("rank_step_seconds")
        new += self.straggler.update(epoch, step_s_per_rank)

        halo = totals.get(self.cfg.skew_metric)
        if halo is not None:
            new += self.skew.update(epoch, halo)
            if self.drift is not None:
                new += self.drift.update(epoch, halo)

        hot = totals.get(self.cfg.hot_metric)
        if hot is not None and halo is not None:
            new += self.hot_decay.update(
                epoch, float(np.sum(hot)), float(np.sum(halo)))

        if self.slo is not None and latency_hist is not None:
            new += self.slo.update(epoch, latency_hist)

        if reg.enabled:
            for gname, val in (
                    ("health_skew", self.skew.last_skew),
                    ("health_edge_cut_drift",
                     self.drift.last_drift if self.drift else None),
                    ("health_slo_burn",
                     self.slo.last_burn if self.slo else None),
                    ("health_hot_rate", self.hot_decay.last_rate)):
                if val is not None:
                    reg.gauge(gname).set(val)

        for d in new:
            self._on_detection(d, reg)
        self.detections.extend(new)
        return new

    # serve rounds are the serve-side window unit; same machinery
    observe_round = observe_epoch

    def observe_audit(self, epoch: int, mean_err: Optional[float]
                      ) -> List[detect.Detection]:
        """Feed one exactness-audit result (the quality plane's mean
        relative-L2 error; ``None`` = audit sampled nothing) through the
        budget detector.  Audits are sparser than epochs, so they get
        their own entry point instead of riding ``observe_epoch``."""
        if not self.enabled:
            return []
        reg = self._reg()
        self.recorder.note("audit", epoch=int(epoch),
                           mean_err=None if mean_err is None
                           else round(float(mean_err), 6))
        if reg.enabled and mean_err is not None:
            reg.gauge("health_audit_err").set(float(mean_err))
        if self.quality is None:
            return []
        new = self.quality.update(int(epoch), mean_err)
        for d in new:
            self._on_detection(d, reg)
        self.detections.extend(new)
        return new

    # -- anomaly handling -----------------------------------------------------
    def _on_detection(self, d: detect.Detection, reg: MetricsRegistry):
        self.recorder.note("detection", **d.to_json())
        if reg.enabled:
            reg.log_event("detection", **d.to_json())
            reg.counter("health_detections", detector=d.detector).inc()
        if self.cfg.dump_on_detection:
            self.flight_paths.append(self.recorder.dump(
                d.reason, self.cfg.flight_dir,
                extra={"detection": d.to_json()}))

    def handle_exception(self, exc: BaseException, label: str) -> str:
        """Record + dump an exception that escaped a guarded loop."""
        tb = traceback.format_exc(limit=20)
        self.recorder.note("exception", label=label,
                           type=type(exc).__name__, repr=repr(exc))
        path = self.recorder.dump(
            f"exception_{label}", self.cfg.flight_dir,
            extra={"exception": {"label": label,
                                 "type": type(exc).__name__,
                                 "repr": repr(exc),
                                 "traceback": tb}})
        self.flight_paths.append(path)
        return path

    @contextmanager
    def guard(self, label: str = "step_loop"):
        """Dump a flight recording when an exception escapes, then
        re-raise — the wrapper every step loop runs under."""
        try:
            yield self
        except BaseException as exc:       # noqa: BLE001 — record, re-raise
            if self.enabled:
                self.handle_exception(exc, label)
            raise

    # -- reporting ------------------------------------------------------------
    def summary(self) -> dict:
        return {
            "enabled": self.enabled,
            "windows": self._window,
            "detections": [d.to_json() for d in self.detections],
            "flight_paths": list(dict.fromkeys(self.flight_paths)),
            "skew": self.skew.last_skew,
            "edge_cut_drift": self.drift.last_drift if self.drift else None,
            "slo_burn": self.slo.last_burn if self.slo else None,
            "hot_rate": self.hot_decay.last_rate,
            "audit_err": self.quality.last_err if self.quality else None,
        }
