"""Metrics registry (own copy of the part of ``repro/obs/registry.py`` the
serve path calls): labeled counters and bounded-window histograms with
exact percentiles.  Instruments are addressed by ``(name, labels)`` and
memoized; observability never feeds back into computation.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict

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

    def reset(self):
        self.samples.clear()
        self.count = 0

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


class MetricsRegistry:
    """Labeled instrument store."""

    def __init__(self, window: int = 8192):
        self.window = window
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._histograms: Dict[str, Histogram] = {}

    def _get(self, store, name, labels, make):
        key = _key(name, labels)
        inst = store.get(key)
        if inst is None:
            with self._lock:
                inst = store.setdefault(key, make())
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(self._counters, name, labels, Counter)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(self._histograms, name, labels,
                         lambda: Histogram(self.window))

    def value(self, name: str, default: float = 0.0, **labels) -> float:
        """Current counter value WITHOUT creating the instrument."""
        inst = self._counters.get(_key(name, labels))
        return inst.value if inst is not None else default
