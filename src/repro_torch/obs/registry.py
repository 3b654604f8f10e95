"""Metrics registry (own copy of ``repro/obs/registry.py``): the single
sink for the port's runtime counters.

Three instrument kinds, cheap enough to stay on by default:

  * :class:`Counter` — monotonically accumulating float (``inc``),
  * :class:`Gauge` — last-written value (``set``),
  * :class:`Histogram` — bounded-window samples with exact window
    percentiles (``np.percentile`` on the retained samples), p50/p99/
    max/mean summaries, and the serving schedulers' latency dict.

Instruments are addressed by ``(name, labels)`` and memoized.  A
registry built with ``enabled=False`` hands out shared no-op
instruments; observability never feeds back into computation.  The
registry also keeps an ordered event log (``log_event``) and writes
JSONL (``write_jsonl``: one line per instrument, then one per event) and
the Prometheus text exposition (``to_prom_text``, ``PromFileWriter``),
byte for byte as the reference writes them.
"""
from __future__ import annotations

import json
import os
import re
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


def _key(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic accumulator (float; increments may be numpy scalars)."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, amount=1.0):
        self.value += float(amount)


class Gauge:
    """Last-written value."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, value):
        self.value = float(value)


class Histogram:
    """Bounded-window sample accumulator with exact window percentiles.

    Keeps the most recent ``window`` samples (plus a lifetime count);
    percentiles are ``np.percentile`` on the retained raw samples."""
    __slots__ = ("samples", "count")

    def __init__(self, window: int = 8192):
        self.samples: deque = deque(maxlen=window)
        self.count = 0

    def observe(self, value: float):
        self.samples.append(value)
        self.count += 1

    def observe_many(self, values):
        """Bulk observe; only the last ``window`` samples can survive, so
        a larger batch is cut to its tail first."""
        a = np.asarray(values, np.float64).reshape(-1)
        n = a.size
        maxlen = self.samples.maxlen
        if maxlen is not None and n > maxlen:
            a = a[-maxlen:]
        self.samples.extend(a.tolist())
        self.count += n

    def reset(self):
        self.samples.clear()
        self.count = 0

    def percentile(self, q: float) -> float:
        if not self.samples:
            return 0.0
        return float(np.percentile(np.asarray(self.samples, np.float64), q))

    def summary(self) -> dict:
        """Exact window stats: count (lifetime), p50/p99/max/mean."""
        if not self.samples:
            return {"count": self.count, "p50": 0.0, "p99": 0.0,
                    "max": 0.0, "mean": 0.0}
        a = np.asarray(self.samples, np.float64)
        return {"count": self.count,
                "p50": float(np.percentile(a, 50)),
                "p99": float(np.percentile(a, 99)),
                "max": float(a.max()),
                "mean": float(a.mean())}

    def metrics(self, prefix: str = "latency") -> dict:
        """The serving scheduler's latency dict (samples are seconds,
        reported in ms) — the reference scheduler's keys."""
        if not self.samples:
            return {f"{prefix}_count": self.count, f"{prefix}_p50_ms": 0.0,
                    f"{prefix}_p99_ms": 0.0, f"{prefix}_mean_ms": 0.0}
        a = np.asarray(self.samples, np.float64) * 1e3
        return {f"{prefix}_count": self.count,
                f"{prefix}_p50_ms": float(np.percentile(a, 50)),
                f"{prefix}_p99_ms": float(np.percentile(a, 99)),
                f"{prefix}_mean_ms": float(a.mean())}


class _NullCounter(Counter):
    __slots__ = ()

    def inc(self, amount=1.0):
        pass


class _NullGauge(Gauge):
    __slots__ = ()

    def set(self, value):
        pass


class _NullHistogram(Histogram):
    __slots__ = ()

    def observe(self, value):
        pass

    def observe_many(self, values):
        pass


_NULL_COUNTER = _NullCounter()
_NULL_GAUGE = _NullGauge()
_NULL_HISTOGRAM = _NullHistogram()


class MetricsRegistry:
    """Labeled instrument store + ordered event log + JSONL sink."""

    def __init__(self, enabled: bool = True, window: int = 8192):
        self.enabled = enabled
        self.window = window
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self.events: List[dict] = []

    # -- instrument accessors (memoized by name+labels) ----------------------
    def _get(self, store, name, labels, make, null):
        if not self.enabled:
            return null
        key = _key(name, labels)
        inst = store.get(key)
        if inst is None:
            with self._lock:
                inst = store.setdefault(key, make())
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(self._counters, name, labels, Counter, _NULL_COUNTER)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(self._gauges, name, labels, Gauge, _NULL_GAUGE)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(self._histograms, name, labels,
                         lambda: Histogram(self.window), _NULL_HISTOGRAM)

    # -- event log -----------------------------------------------------------
    def log_event(self, kind: str, **payload):
        if self.enabled:
            self.events.append({"kind": kind, **payload})

    def events_of(self, kind: str) -> Iterator[dict]:
        return (e for e in self.events if e["kind"] == kind)

    # -- aggregation / export ------------------------------------------------
    def value(self, name: str, default: float = 0.0, **labels) -> float:
        """Current counter/gauge value WITHOUT creating the instrument."""
        key = _key(name, labels)
        inst = self._counters.get(key) or self._gauges.get(key)
        return inst.value if inst is not None else default

    def rate(self, num: str, den: str, default: float = 0.0) -> float:
        """Summed numerator over summed denominator (not a mean of
        per-step ratios)."""
        d = self.value(den)
        return self.value(num) / d if d else default

    def rate_or_none(self, num: str, den: str) -> Optional[float]:
        """Like :meth:`rate` but ``None`` on a zero/absent denominator: a
        window with no lookups has no hit rate, not a 0% one."""
        d = self.value(den)
        return self.value(num) / d if d else None

    def snapshot(self) -> dict:
        """Flat ``{key: value}`` view; histograms expand to their summary
        sub-keys (``<key>.p50`` etc.)."""
        out = {k: c.value for k, c in self._counters.items()}
        out.update({k: g.value for k, g in self._gauges.items()})
        for k, h in self._histograms.items():
            for sk, sv in h.summary().items():
                out[f"{k}.{sk}"] = sv
        return out

    def write_jsonl(self, path: str) -> str:
        """One JSON line per instrument (``{"metric", "kind", ...}``) then
        one per logged event (``{"event", ...}``)."""
        with open(path, "w") as f:
            for k, c in sorted(self._counters.items()):
                f.write(json.dumps({"metric": k, "kind": "counter",
                                    "value": c.value}) + "\n")
            for k, g in sorted(self._gauges.items()):
                f.write(json.dumps({"metric": k, "kind": "gauge",
                                    "value": g.value}) + "\n")
            for k, h in sorted(self._histograms.items()):
                f.write(json.dumps({"metric": k, "kind": "histogram",
                                    **h.summary()}) + "\n")
            for e in self.events:
                f.write(json.dumps({"event": e["kind"],
                                    **{k: v for k, v in e.items()
                                       if k != "kind"}}) + "\n")
        return path

    def to_prom_text(self) -> str:
        """Prometheus text exposition of every live instrument: counters
        and gauges 1:1; histograms as a ``summary`` with exact window
        quantiles 0.5 and 0.99, ``_sum`` (over the window) and ``_count``
        (lifetime).  Names are cut to the Prometheus charset, label
        values escaped."""
        lines: List[str] = []
        typed: set = set()

        def head(name: str, kind: str):
            if name not in typed:
                typed.add(name)
                lines.append(f"# TYPE {name} {kind}")

        def fmt(value: float) -> str:
            return repr(float(value))

        for key, c in sorted(self._counters.items()):
            name, labels = _parse_key(key)
            head(name, "counter")
            lines.append(f"{name}{_prom_labels(labels)} {fmt(c.value)}")
        for key, g in sorted(self._gauges.items()):
            name, labels = _parse_key(key)
            head(name, "gauge")
            lines.append(f"{name}{_prom_labels(labels)} {fmt(g.value)}")
        for key, h in sorted(self._histograms.items()):
            name, labels = _parse_key(key)
            head(name, "summary")
            for q in (50.0, 99.0):
                ql = dict(labels)
                ql["quantile"] = f"{q / 100:g}"
                lines.append(
                    f"{name}{_prom_labels(ql)} {fmt(h.percentile(q))}")
            window_sum = float(np.sum(h.samples)) if h.samples else 0.0
            lines.append(f"{name}_sum{_prom_labels(labels)} {fmt(window_sum)}")
            lines.append(f"{name}_count{_prom_labels(labels)} {h.count}")
        return "\n".join(lines) + "\n" if lines else ""

    def reset(self):
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self.events.clear()


def _parse_key(key: str) -> Tuple[str, Dict[str, str]]:
    """Invert :func:`_key`: ``name{k=v,...}`` -> sanitised name + labels."""
    name, _, rest = key.partition("{")
    labels: Dict[str, str] = {}
    if rest:
        for item in rest[:-1].split(","):
            k, _, v = item.partition("=")
            labels[_prom_name(k)] = v
    return _prom_name(name), labels


def _prom_name(name: str) -> str:
    name = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    return f"_{name}" if not name or name[0].isdigit() else name


def _prom_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""

    def esc(v: str) -> str:
        return str(v).replace("\\", r"\\").replace('"', r"\"") \
                     .replace("\n", r"\n")
    inner = ",".join(f'{k}="{esc(v)}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class PromFileWriter:
    """``to_prom_text`` written to ``path`` (the launchers' ``--prom-out``):
    through a temp file in the same directory and an atomic rename, so a
    scraping collector never reads a torn file.  ``maybe_write`` writes at
    most once per ``min_interval_s``."""

    def __init__(self, path: str, min_interval_s: float = 0.0):
        self.path = path
        self.min_interval_s = float(min_interval_s)
        self.writes = 0
        self._last_write: Optional[float] = None

    def write(self, reg: MetricsRegistry) -> str:
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(reg.to_prom_text())
        os.replace(tmp, self.path)
        self.writes += 1
        self._last_write = time.monotonic()
        return self.path

    def maybe_write(self, reg: MetricsRegistry) -> Optional[str]:
        if (self._last_write is not None and self.min_interval_s > 0.0
                and time.monotonic() - self._last_write
                < self.min_interval_s):
            return None
        return self.write(reg)


def hit_rate_metrics(reg: MetricsRegistry) -> dict:
    """Per-layer cache hit rates from summed counters: for every layer
    ``l`` with a ``hec_hits_l{l}`` counter, ``hec_hit_rate_l{l}`` = hits
    over ``hec_halos_l{l}`` and, where ``hot_hits_l{l}`` exists,
    ``hot_hit_rate_l{l}`` = hot hits over the same halos.  A layer with no
    halo looked up is left out (no rate, not a 0% one)."""
    out = {}
    for key in list(reg._counters):
        if not key.startswith("hec_hits_l"):
            continue
        l = key[len("hec_hits_l"):]
        rate = reg.rate_or_none(key, f"hec_halos_l{l}")
        if rate is None:
            continue
        out[f"hec_hit_rate_l{l}"] = rate
        if f"hot_hits_l{l}" in reg._counters:
            out[f"hot_hit_rate_l{l}"] = reg.rate(f"hot_hits_l{l}",
                                                 f"hec_halos_l{l}")
    return out
