"""Observability for the port's serve path (own copy of the minimum of
``repro/obs``): one process-wide runtime holding a metrics registry, and
the module-level helpers instrumented code calls::

    from repro_torch import obs
    with obs.span("serve_round"):
        ...
    obs.count("serve_cache_hits", n, layer=1)
    obs.observe("serve_latency_s", dt, subsystem="serve")

``span`` accumulates ``phase_seconds{phase=<name>}`` and
``phase_calls{phase=<name>}`` on the host clock.  Trace export, the
disabled mode and the health and quality planes are not ported yet.
"""
from __future__ import annotations

import time

from repro_torch.obs.registry import (Counter, Histogram,  # noqa: F401
                                      MetricsRegistry)


class _PhaseSpan:
    """Times one phase into ``phase_seconds``/``phase_calls``."""
    __slots__ = ("_reg", "_name", "_t0")

    def __init__(self, reg: MetricsRegistry, name: str):
        self._reg = reg
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._reg.counter("phase_seconds", phase=self._name).inc(dt)
        self._reg.counter("phase_calls", phase=self._name).inc(1)
        return False


class Observability:
    """The runtime: one registry."""

    def __init__(self):
        self.registry = MetricsRegistry()

    def span(self, name: str) -> _PhaseSpan:
        return _PhaseSpan(self.registry, name)

    def count(self, name: str, amount=1.0, **labels):
        self.registry.counter(name, **labels).inc(amount)

    def observe(self, name: str, value: float, **labels):
        self.registry.histogram(name, **labels).observe(value)


_runtime = Observability()


def get() -> Observability:
    """The active process-wide runtime."""
    return _runtime


def configure() -> Observability:
    """Install (and return) a fresh runtime: every instrument at zero."""
    global _runtime
    _runtime = Observability()
    return _runtime


def span(name: str) -> _PhaseSpan:
    return _runtime.span(name)


def count(name: str, amount=1.0, **labels):
    _runtime.count(name, amount, **labels)


def observe(name: str, value: float, **labels):
    _runtime.observe(name, value, **labels)
