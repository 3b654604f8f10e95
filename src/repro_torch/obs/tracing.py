"""Phase-span tracing with Chrome trace-event export (own copy of
``repro/obs/tracing.py``).

``Tracer.record`` keeps one complete (``"ph": "X"``) event per span,
timestamps in microseconds from the tracer's epoch, ``pid`` the rank and
``tid`` a dense per-thread id, so the JSON loads in chrome://tracing or
Perfetto with the prefetch workers on rows of their own.  Nesting is
per thread: each thread keeps its own span stack, and an event's args
carry its depth and parent.  ``add_complete`` records a span at explicit
times on a named virtual track; on the card the launchers put the
device's kernels and copies there, one track per CUDA stream
(``obs/device_trace.py``).  Tracing is opt-in: a disabled tracer is
never consulted.
"""
from __future__ import annotations

import json
import threading
import time
from typing import List, Optional


class Tracer:
    """Thread-aware span recorder + Chrome trace-event JSON exporter."""

    def __init__(self, enabled: bool = False, rank: int = 0):
        self.enabled = enabled
        self.rank = rank
        self.epoch = time.perf_counter()
        self.events: List[dict] = []
        self._lock = threading.Lock()
        self._tids: dict = {}             # thread ident / virtual name -> tid
        self._local = threading.local()

    # -- thread bookkeeping --------------------------------------------------
    def _tid(self, key=None) -> int:
        if key is None:
            key = threading.get_ident()
            name = threading.current_thread().name
        else:
            name = str(key)
        tid = self._tids.get(key)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(key, len(self._tids))
                self.events.append({
                    "name": "thread_name", "ph": "M", "pid": self.rank,
                    "tid": tid, "args": {"name": name}})
        return tid

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @property
    def depth(self) -> int:
        """Current span nesting depth on the calling thread."""
        return len(self._stack())

    # -- recording -----------------------------------------------------------
    def push(self, name: str):
        self._stack().append(name)

    def record(self, name: str, t0: float, t1: float, cat: str = "phase",
               args: Optional[dict] = None):
        """Record a completed span timed with ``time.perf_counter``; pops
        the thread's span stack (pushed at span entry)."""
        stack = self._stack()
        depth = len(stack) - 1
        parent = stack[-2] if depth > 0 else None
        if stack:
            stack.pop()
        ev = {"name": name, "ph": "X", "cat": cat,
              "ts": (t0 - self.epoch) * 1e6, "dur": (t1 - t0) * 1e6,
              "pid": self.rank, "tid": self._tid()}
        a = dict(args) if args else {}
        a["depth"] = depth
        if parent is not None:
            a["parent"] = parent
        ev["args"] = a
        self.events.append(ev)

    def add_complete(self, name: str, start_s: float, dur_s: float,
                     track: str = "modeled", cat: str = "modeled",
                     args: Optional[dict] = None):
        """Record a span at explicit ``[start_s, start_s + dur_s]``
        (seconds from the trace origin) on virtual thread ``track``."""
        ev = {"name": name, "ph": "X", "cat": cat, "ts": start_s * 1e6,
              "dur": dur_s * 1e6, "pid": self.rank,
              "tid": self._tid(("virtual", track))}
        if args:
            ev["args"] = dict(args)
        self.events.append(ev)

    def counter_event(self, name: str, when_s: float, values: dict):
        """Chrome "C" counter event (e.g. queue depth over trace time)."""
        self.events.append({"name": name, "ph": "C", "ts": when_s * 1e6,
                            "pid": self.rank, "args": dict(values)})

    # -- export --------------------------------------------------------------
    def export(self) -> dict:
        """The Chrome trace-event JSON object: ``traceEvents`` and
        ``displayTimeUnit``."""
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}

    def write(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.export(), f)
            f.write("\n")
        return path

    def reset(self):
        with self._lock:
            self.events.clear()
            self._tids.clear()


def validate_chrome_trace(trace: dict) -> int:
    """Schema check of an exported trace; returns the number of duration
    events and raises ``ValueError`` at the first violation."""
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise ValueError("trace must be an object with 'traceEvents'")
    events = trace["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be a list")
    n_spans = 0
    for ev in events:
        for field in ("name", "ph", "pid", "tid"):
            if field not in ev and ev.get("ph") != "C":
                raise ValueError(f"event missing '{field}': {ev}")
        if ev["ph"] == "X":
            if "ts" not in ev or "dur" not in ev:
                raise ValueError(f"complete event missing ts/dur: {ev}")
            if ev["dur"] < 0:
                raise ValueError(f"negative duration: {ev}")
            n_spans += 1
        elif ev["ph"] not in ("M", "C", "B", "E", "i"):
            raise ValueError(f"unknown phase '{ev['ph']}'")
    return n_spans
