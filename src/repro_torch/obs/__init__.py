"""Observability (own copy of ``repro/obs``'s runtime, registry, tracing
and epoch breakdown): one process-wide :class:`Observability` runtime,
swapped with ``configure``, owns

  * a :class:`MetricsRegistry` — counters, gauges and histograms by
    name and labels, with JSONL and Prometheus sinks; default on,
  * a :class:`Tracer` — phase spans (``sample``, ``host_prep``,
    ``stage``, ``step``, ``serve_round``, ...) with per-thread nesting,
    written as Chrome trace-event JSON; opt-in (``ObsConfig(trace=True)``
    or the launchers' ``--trace-out``), where on the card
    :class:`DeviceTrace` adds the device's kernels and copies, one track
    per CUDA stream,
  * :class:`EpochBreakdown` / :class:`StepModel` — per-epoch sample /
    host-prep / H2D / forward / push / backward shares and the modeled
    overlap efficiency,
  * the **cluster health plane** (:mod:`~repro_torch.obs.cluster`,
    :mod:`~repro_torch.obs.detect`, :mod:`~repro_torch.obs.sentinel`):
    per-rank series summed into rank-labeled counters and sum/mean/max/
    skew cluster views, the straggler, load-skew, edge-cut-drift,
    SLO-burn, hot-tier-decay and quality-budget detectors, and the
    bounded flight recorder that dumps ``FLIGHT_<reason>.json`` on a
    detection or an escaped exception (:class:`HealthPlane`, wired by
    ``DistTrainer(health=...)`` and the serve schedulers' ``health=``),
  * the **embedding quality plane** (:mod:`~repro_torch.obs.quality`):
    per-layer HEC and hot-tier staleness histograms, the online
    exactness audit (sampled cached embeddings against exact offline
    recomputation, relative L2) and the per-epoch convergence series
    (:class:`QualityPlane`, wired by ``DistTrainer(quality=...)`` and the
    schedulers' ``quality=``; the training audit armed by
    ``--audit-interval``).

Instrumented code calls the module-level helpers::

    from repro_torch import obs
    with obs.span("sample", epoch=ep, step=k):
        ...
    obs.count("serve_cache_hits", n, layer=1)

With everything disabled (``ObsConfig(enabled=False)``) ``span`` returns
one shared no-op object and the instruments are no-ops; observability
only reads host clocks, counters and cache state, so outputs are the same
with it on, off or tracing.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

from repro_torch.obs.breakdown import (MEASURED_PHASES,  # noqa: F401
                                       REPORT_PHASES, EpochBreakdown,
                                       StepModel)
from repro_torch.obs.cluster import (RankAccumulator,  # noqa: F401
                                     SeriesView, publish_rank_series,
                                     rank_series, skew_ratio)
from repro_torch.obs.detect import (Detection,  # noqa: F401
                                    EdgeCutDriftDetector,
                                    HotTierDecayDetector, LoadSkewDetector,
                                    QualityBudgetDetector, SLOBurnDetector,
                                    StragglerDetector)
from repro_torch.obs.device_trace import (DeviceTrace,  # noqa: F401
                                          busy_us, device_events,
                                          device_summary,
                                          stream_overlap_us)
from repro_torch.obs.quality import (AuditReport,  # noqa: F401
                                     QualityConfig, QualityPlane,
                                     relative_l2)
from repro_torch.obs.registry import (Counter, Gauge,  # noqa: F401
                                      Histogram, MetricsRegistry,
                                      PromFileWriter, hit_rate_metrics)
from repro_torch.obs.sentinel import (FlightRecorder,  # noqa: F401
                                      HealthConfig, HealthPlane)
from repro_torch.obs.tracing import (Tracer,  # noqa: F401
                                     validate_chrome_trace)


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """``enabled`` gates the registry (default on); ``trace`` gates span
    tracing (default off).  ``flush()`` writes ``trace_path`` and
    ``metrics_path``."""
    enabled: bool = True
    trace: bool = False
    trace_path: Optional[str] = None
    metrics_path: Optional[str] = None
    window: int = 8192            # histogram sample window
    rank: int = 0                 # trace pid (one process == one rank here)


class _NullSpan:
    """Shared no-op context manager returned when obs is fully disabled."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _PhaseSpan:
    """Times one phase: accumulates ``phase_seconds{phase=<name>}`` and
    ``phase_calls`` in the registry (when enabled) and records a trace
    event with ``args`` (when tracing)."""
    __slots__ = ("_obs", "_name", "_args", "_t0")

    def __init__(self, runtime: "Observability", name: str, args: dict):
        self._obs = runtime
        self._name = name
        self._args = args

    def __enter__(self):
        if self._obs.tracer.enabled:
            self._obs.tracer.push(self._name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        o = self._obs
        if o.registry.enabled:
            o.registry.counter("phase_seconds",
                               phase=self._name).inc(t1 - self._t0)
            o.registry.counter("phase_calls", phase=self._name).inc(1)
        if o.tracer.enabled:
            o.tracer.record(self._name, self._t0, t1, args=self._args)
        return False


class Observability:
    """The runtime: one registry + one tracer (+ flush plumbing)."""

    def __init__(self, cfg: Optional[ObsConfig] = None):
        self.cfg = cfg or ObsConfig()
        self.registry = MetricsRegistry(enabled=self.cfg.enabled,
                                        window=self.cfg.window)
        self.tracer = Tracer(enabled=self.cfg.trace, rank=self.cfg.rank)

    def span(self, name: str, **args):
        if not (self.registry.enabled or self.tracer.enabled):
            return _NULL_SPAN
        return _PhaseSpan(self, name, args)

    def count(self, name: str, amount=1.0, **labels):
        self.registry.counter(name, **labels).inc(amount)

    def observe(self, name: str, value: float, **labels):
        self.registry.histogram(name, **labels).observe(value)

    def set_gauge(self, name: str, value: float, **labels):
        self.registry.gauge(name, **labels).set(value)

    def phase_seconds(self, phase: str) -> float:
        """Accumulated seconds of one phase (0.0 while disabled)."""
        return self.registry.value("phase_seconds", phase=phase)

    def flush(self) -> List[str]:
        """Write the configured trace/metrics files; returns paths."""
        paths = []
        if self.cfg.trace_path and self.tracer.enabled:
            paths.append(self.tracer.write(self.cfg.trace_path))
        if self.cfg.metrics_path and self.registry.enabled:
            paths.append(self.registry.write_jsonl(self.cfg.metrics_path))
        return paths


_runtime = Observability()


def get() -> Observability:
    """The active process-wide runtime."""
    return _runtime


def configure(cfg: Optional[ObsConfig] = None) -> Observability:
    """Install (and return) a fresh runtime; ``configure()`` restores the
    defaults (counters on, tracing off)."""
    global _runtime
    _runtime = Observability(cfg)
    return _runtime


# -- module-level helpers (proxy to the active runtime) ----------------------
def span(name: str, **args):
    return _runtime.span(name, **args)


def count(name: str, amount=1.0, **labels):
    _runtime.count(name, amount, **labels)


def observe(name: str, value: float, **labels):
    _runtime.observe(name, value, **labels)


def set_gauge(name: str, value: float, **labels):
    _runtime.set_gauge(name, value, **labels)


def phase_seconds(phase: str) -> float:
    return _runtime.phase_seconds(phase)


def flush() -> List[str]:
    return _runtime.flush()
