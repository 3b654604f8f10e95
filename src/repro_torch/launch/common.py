"""The launchers' shared observability flags (the reference launchers'
``--trace-out/--metrics-out/--prom-out`` plumbing):

  --trace-out PATH    Chrome trace-event JSON of the phase spans; on the
                      card also the device's kernels and copies (one
                      track per CUDA stream), and the device busy share
                      is printed, as the union of device intervals
  --metrics-out PATH  the registry as JSONL
  --prom-out PATH     the registry in Prometheus text format
"""
from __future__ import annotations

import argparse
import contextlib
from typing import Optional, Sequence

from repro_torch import obs


def add_obs_flags(ap: argparse.ArgumentParser):
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome trace-event JSON of the phase "
                         "spans (on the card with the device's kernels "
                         "and copies, one track per CUDA stream)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the obs registry as JSONL")
    ap.add_argument("--prom-out", default=None, metavar="PATH",
                    help="write the registry in Prometheus text format "
                         "(node-exporter textfile collector)")


def configure_obs(args) -> obs.Observability:
    """A fresh runtime with the flags' trace and metrics paths."""
    return obs.configure(obs.ObsConfig(
        trace=args.trace_out is not None, trace_path=args.trace_out,
        metrics_path=args.metrics_out))


def prom_writer(args) -> Optional[obs.PromFileWriter]:
    if args.prom_out is None:
        return None
    return obs.PromFileWriter(args.prom_out, min_interval_s=1.0)


def device_trace(args, device):
    """With ``--trace-out``: a :class:`~repro_torch.obs.DeviceTrace` of
    ``device`` into the runtime's tracer, else a null context."""
    if args.trace_out is None:
        return contextlib.nullcontext()
    return obs.DeviceTrace(device, obs.get().tracer)


def span_windows(name: str):
    """The ``[t0, t1]`` µs of every traced ``name`` span so far."""
    return [(e["ts"], e["ts"] + e["dur"]) for e in obs.get().tracer.events
            if e.get("ph") == "X" and e["name"] == name
            and e.get("cat") == "phase"]


def report_device(dt, label: str, spans: Sequence[str] = ()) -> dict:
    """Print and return the device summary of a :class:`DeviceTrace`:
    the traced window's busy share and, per name in ``spans``, the busy
    share inside those spans; ``{}`` without a trace or a card."""
    if not isinstance(dt, obs.DeviceTrace):
        return {}
    if dt.device.type != "cuda":
        print(f"device:     {label}: not measured (no CUDA device)")
        return {}
    out = {"window": dt.summary()}
    for name in spans:
        wins = span_windows(name)
        if wins:
            out[name] = dt.summary(wins)
    for key, s in out.items():
        where = "traced window" if key == "window" else f"'{key}' spans"
        per = "; ".join(
            f"stream {sid}: {v['device_us'] / 1e3:.2f} ms, {v['kernels']} "
            f"kernels, {v['memcpys']} copies, {v['overlap_us'] / 1e3:.2f} "
            f"ms overlapping other streams"
            for sid, v in s["streams"].items())
        print(f"device:     {label}, {where}: {s['wall_us'] / 1e3:.1f} ms "
              f"wall, busy {s['busy_us'] / 1e3:.2f} ms = "
              f"{100 * s['busy_share']:.1f}% (union over "
              f"{len(s['streams'])} streams){'; ' + per if per else ''}")
    return out


def finish_obs(prom: Optional[obs.PromFileWriter]):
    """Write the Prometheus file and the flags' trace and metrics."""
    if prom is not None:
        print(f"wrote {prom.write(obs.get().registry)}")
    for path in obs.flush():
        print(f"wrote {path}")
