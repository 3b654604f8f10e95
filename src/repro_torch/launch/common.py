"""The launchers' shared observability flags (the reference launchers'
``--trace-out/--metrics-out/--prom-out`` plumbing and their health and
quality planes):

  --trace-out PATH    Chrome trace-event JSON of the phase spans; on the
                      card also the device's kernels and copies (one
                      track per CUDA stream), and the device busy share
                      is printed, as the union of device intervals
  --metrics-out PATH  the registry as JSONL
  --prom-out PATH     the registry in Prometheus text format
  --flight-dir DIR    where the health plane dumps FLIGHT_*.json on a
                      detection or an escaped exception (default .)
  --audit-interval N  the exactness audit every N epochs (training) or
                      after each serve pass (serving); 0 = off
  --quality-budget E  arm the quality-budget detector (audit mean error
                      over E for two audits dumps FLIGHT_quality.json)
  --slo-p99-ms T      (serving) arm the SLO-burn detector at this p99

:func:`build_planes` builds the two planes from these flags, as the
reference launchers do.
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


def add_plane_flags(ap: argparse.ArgumentParser, serving: bool):
    """The health and quality planes' flags (``--slo-p99-ms`` on the
    serving launchers only)."""
    ap.add_argument("--flight-dir", default=".", metavar="DIR",
                    help="where the health plane dumps FLIGHT_*.json on a "
                         "detection or an escaped exception")
    ap.add_argument("--audit-interval", type=int, default=0, metavar="N",
                    help="N > 0: run the exactness audit (sampled cached "
                         "embeddings against an offline recompute, "
                         "relative L2 error) every N epochs, or after each "
                         "serve pass")
    ap.add_argument("--quality-budget", type=float, default=None,
                    metavar="ERR",
                    help="arm the quality-budget detector: audit mean "
                         "error persistently above ERR dumps "
                         "FLIGHT_quality.json")
    if serving:
        ap.add_argument("--slo-p99-ms", type=float, default=None,
                        help="arm the SLO-burn detector with this p99 "
                             "target")


def build_planes(args, num_ranks: int, expected_halo_rows=None,
                 prom: Optional[obs.PromFileWriter] = None,
                 quality_always: bool = False):
    """``(health, quality)`` from the plane flags: a health plane always
    (its edge-cut drift detector armed by ``expected_halo_rows``, its SLO
    burn by ``--slo-p99-ms``), a quality plane where ``quality_always``
    (training: staleness every epoch) or ``--audit-interval`` asks."""
    slo = getattr(args, "slo_p99_ms", None)
    health = obs.HealthPlane(
        obs.HealthConfig(flight_dir=args.flight_dir,
                         slo_p99_s=None if slo is None else slo / 1e3,
                         quality_budget=args.quality_budget),
        num_ranks=num_ranks, expected_halo_rows=expected_halo_rows)
    quality = obs.QualityPlane(
        obs.QualityConfig(audit_interval=args.audit_interval),
        health=health, prom=prom) \
        if quality_always or args.audit_interval else None
    return health, quality


def print_audit(label: str, report):
    """One line of an audit's result."""
    fmt = "n/a" if report.mean_err is None else f"{report.mean_err:.5f}"
    print(f"audit:      [{label}] mean rel-L2 err={fmt} over "
          f"{sum(v['n'] for v in report.per_layer.values())} sampled lines")


def print_health(health):
    """The health plane's summary and its flight files."""
    hs = health.summary()
    fmt = lambda v: "n/a" if v is None else f"{v:.3f}"  # noqa: E731
    print(f"health:     {hs['windows']} windows observed, halo skew="
          f"{fmt(hs['skew'])}, edge-cut drift={fmt(hs['edge_cut_drift'])}, "
          f"slo burn={fmt(hs['slo_burn'])}, {len(hs['detections'])} "
          f"detections")
    for p in hs["flight_paths"]:
        print(f"flight:     {p}")


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
