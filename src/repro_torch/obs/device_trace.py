"""The device's side of a trace: what the card ran, on which CUDA stream,
and when.

:class:`DeviceTrace` runs ``torch.profiler`` (CPU and CUDA activity) over
a window on the card and keeps every kernel, memcpy and memset as
``{"name", "cat", "stream", "ts", "dur"}`` (microseconds on the given
:class:`~repro_torch.obs.tracing.Tracer`'s clock, aligned by two
``record_function`` anchors at the window's ends); with a tracer that is
on, it adds them to the trace as complete events on one track per
stream (``cuda stream <id>``), beside the host spans.  On the CPU it
records nothing.

The busy share of a window is the **union** of the device intervals over
every stream (``busy_us``), so two streams that overlap never count one
moment twice; ``stream_overlap_us`` is how much of one stream's device
time overlaps another set of streams' (the AEP push on its side stream
against the main stream's kernels).  ``device_events`` reads the device
events back from an exported trace.
"""
from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from repro_torch.obs.tracing import Tracer

DEVICE_CATS = ("device_kernel", "device_memcpy", "device_memset")
_ANCHOR = "obs_device_trace_anchor"


def _ns(ev, what: str) -> float:
    """A kineto event's start or duration in ns (older torch has only
    the microsecond accessors)."""
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return float(f())
    return float(getattr(ev, f"{what}_us")()) * 1e3


def _category(name: str) -> str:
    if name.startswith("Memcpy"):
        return "device_memcpy"
    if name.startswith("Memset"):
        return "device_memset"
    return "device_kernel"


class DeviceTrace:
    """Context manager: the device events of a window on ``device``
    (nothing on the CPU), on ``tracer``'s clock, added to ``tracer``
    when it is on."""

    def __init__(self, device, tracer: Optional[Tracer] = None):
        self.device = torch.device(device)
        self.tracer = tracer
        self.epoch = tracer.epoch if tracer is not None \
            else time.perf_counter()
        self.events: List[dict] = []
        self.window_us: Tuple[float, float] = (0.0, 0.0)
        self._prof = None
        self._anchors: List[float] = []

    def _anchor(self):
        torch.cuda.synchronize(self.device)
        self._anchors.append(time.perf_counter())
        with torch.profiler.record_function(_ANCHOR):
            pass

    def __enter__(self):
        if self.device.type == "cuda":
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.__enter__()
            self._anchor()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._prof is None:
            self.window_us = ((self._t0 - self.epoch) * 1e6,
                              (time.perf_counter() - self.epoch) * 1e6)
            return False
        self._anchor()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._collect()
        return False

    def _collect(self):
        """Device events from the profiler's kineto results, mapped onto
        the host clock by the two anchors."""
        from torch.autograd import DeviceType
        anchors, device = [], []
        for ev in self._prof.profiler.kineto_results.events():
            if ev.device_type() == DeviceType.CUDA:
                device.append(ev)
            elif ev.name() == _ANCHOR:
                anchors.append(_ns(ev, "start"))
        if len(anchors) != 2:
            raise RuntimeError(f"device trace: {len(anchors)} clock anchors "
                               f"in the profile, expected 2")
        (k0, k1), (h0, h1) = sorted(anchors), self._anchors
        scale = (h1 - h0) * 1e9 / (k1 - k0) if k1 > k0 else 1.0
        to_us = lambda ns: ((h0 - self.epoch) * 1e9  # noqa: E731
                            + (ns - k0) * scale) / 1e3
        self.window_us = (to_us(k0), to_us(k1))
        for ev in device:
            name = ev.name()
            start = _ns(ev, "start")
            self.events.append({
                "name": name, "cat": _category(name),
                "stream": int(ev.device_resource_id()),
                "ts": to_us(start),
                "dur": _ns(ev, "duration") * scale / 1e3})
        self.events.sort(key=lambda e: e["ts"])
        tr = self.tracer
        if tr is not None and tr.enabled:
            for e in self.events:
                tr.add_complete(e["name"], e["ts"] / 1e6, e["dur"] / 1e6,
                                track=f"cuda stream {e['stream']}",
                                cat=e["cat"], args={"stream": e["stream"]})

    def summary(self, windows: Optional[Sequence[Tuple[float, float]]] = None
                ) -> dict:
        """Busy time (union over streams) and per-stream device time over
        the traced window or the given ``[t0, t1]`` windows (µs)."""
        return device_summary(self.events, windows or [self.window_us])


def device_events(trace: dict) -> List[dict]:
    """The device events of an exported trace (``Tracer.export()``)."""
    return [{"name": ev["name"], "cat": ev["cat"],
             "stream": ev["args"]["stream"], "ts": ev["ts"],
             "dur": ev["dur"]}
            for ev in trace["traceEvents"]
            if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATS]


def _union(intervals: Iterable[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _intersect(a, b) -> List[Tuple[float, float]]:
    """The intersection of two sorted lists of disjoint intervals, in one
    pass over both."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def _spans(events, streams=None):
    return [(e["ts"], e["ts"] + e["dur"]) for e in events
            if streams is None or e["stream"] in streams]


def busy_us(events: Sequence[dict],
            windows: Optional[Sequence[Tuple[float, float]]] = None
            ) -> float:
    """Device busy time: the union of every event's interval over all
    streams, clipped to ``windows`` (µs; ``None``: unclipped)."""
    spans = _union(_spans(events))
    if windows is not None:
        spans = _intersect(spans, _union(windows))
    return _length(spans)


def stream_overlap_us(events: Sequence[dict], stream: int,
                      others: Iterable[int]) -> float:
    """How much of ``stream``'s device time (its own union) runs while a
    stream of ``others`` is busy (µs)."""
    mine = _union(_spans(events, {stream}))
    theirs = _union(_spans(events, set(others)))
    return _length(_intersect(mine, theirs))


def device_summary(events: Sequence[dict],
                   windows: Sequence[Tuple[float, float]],
                   top: int = 8) -> dict:
    """Over ``windows``: the wall, the busy time and share (union over
    streams), per stream its device time, its kernel and memcpy counts
    and its overlap with the other streams (µs), and the ``top`` event
    names by summed device time."""
    windows = _union(windows)
    wall = _length(windows)
    busy = busy_us(events, windows)
    inside = [e for e in events
              if any(e["ts"] < w1 and e["ts"] + e["dur"] > w0
                     for w0, w1 in windows)]
    by_name: Dict[str, list] = {}
    for e in inside:
        row = by_name.setdefault(e["name"], [0.0, 0])
        row[0] += e["dur"]
        row[1] += 1
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    streams: Dict[int, dict] = {}
    ids = sorted({e["stream"] for e in inside})
    for s in ids:
        mine = [e for e in inside if e["stream"] == s]
        streams[s] = {
            "device_us": _length(_intersect(_union(_spans(mine)),
                                            windows)),
            "kernels": sum(e["cat"] == "device_kernel" for e in mine),
            "memcpys": sum(e["cat"] == "device_memcpy" for e in mine),
            "overlap_us": stream_overlap_us(
                inside, s, [o for o in ids if o != s])}
    return {"wall_us": wall, "busy_us": busy,
            "busy_share": busy / wall if wall > 0 else 0.0,
            "streams": streams,
            "top": [{"name": n, "device_us": t, "calls": c}
                    for n, (t, c) in ranked]}
