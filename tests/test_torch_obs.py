"""The port's observability (``repro_torch.obs``) against the reference's
(``repro.obs``), on the CPU: the registry's sinks byte for byte, the
tracer's Chrome trace, the epoch breakdown, the disabled runtime, the
device trace's union of intervals, and the three launchers' trace,
JSONL and Prometheus files.

Tolerances: none; every comparison is exact (the same float operations
in the same order on both sides), but for the breakdown's shares, which
are equal too.
"""
import json
import threading

import pytest

from repro import obs as j_obs
from repro_torch import obs

PHASES = ("sample", "host_prep", "stage", "step")


def drive(o):
    """One sequence of counter, gauge, histogram and event operations on
    the runtime module ``o`` (either package's), into a fresh registry."""
    reg = o.MetricsRegistry(enabled=True, window=16)
    reg.counter("phase_seconds", phase="step").inc(0.125)
    reg.counter("phase_seconds", phase="sample").inc(1.5)
    reg.counter("phase_seconds", phase="step").inc(2)
    reg.counter("hec_hits_l0").inc(30)
    reg.counter("hec_halos_l0").inc(120)
    reg.counter("hec_hits_l1").inc(7.0)
    reg.counter("hec_halos_l1").inc(0.0)          # no rate for layer 1
    reg.counter("hec_hits_l2").inc(3)
    reg.counter("hec_halos_l2").inc(9)
    reg.counter("hot_hits_l2").inc(2)
    reg.counter("train_epochs_total", sampler_policy="uniform").inc()
    reg.counter("odd-name.x", label='a"b\\c\nd').inc(4)
    reg.counter("9lives").inc(1)
    reg.gauge("hec_occupancy", layer=0).set(0.25)
    reg.gauge("hec_occupancy", layer=0).set(0.5)
    reg.gauge("queue_depth").set(3)
    h = reg.histogram("serve_latency_s", subsystem="serve")
    for v in (0.001, 0.004, 0.002, 0.010, 0.003):
        h.observe(v)
    h.observe_many([0.005 * i for i in range(40)])   # past the window
    reg.histogram("empty_hist")
    reg.log_event("epoch", epoch=0, loss=1.25)
    reg.log_event("audit", layer=2, err=0.5)
    return reg


def test_registry_sinks_match_reference(tmp_path):
    a, b = drive(obs), drive(j_obs)
    assert a.to_prom_text() == b.to_prom_text()
    assert a.snapshot() == b.snapshot()
    pa, pb = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    a.write_jsonl(str(pa))
    b.write_jsonl(str(pb))
    assert pa.read_text() == pb.read_text()
    assert all(json.loads(line) for line in pa.read_text().splitlines())
    assert obs.hit_rate_metrics(a) == j_obs.hit_rate_metrics(b) == {
        "hec_hit_rate_l0": 0.25, "hec_hit_rate_l2": 3 / 9,
        "hot_hit_rate_l2": 2 / 9}
    assert a.rate("hec_hits_l1", "hec_halos_l1", -1.0) == -1.0
    assert a.rate_or_none("hec_hits_l1", "hec_halos_l1") is None
    assert [e["kind"] for e in a.events_of("audit")] == ["audit"]
    h = a.histogram("serve_latency_s", subsystem="serve")
    assert h.summary() == b.histogram("serve_latency_s",
                                      subsystem="serve").summary()
    assert h.count == 45 and len(h.samples) == 16
    assert h.percentile(99) == b.histogram(
        "serve_latency_s", subsystem="serve").percentile(99)
    a.reset()
    assert a.snapshot() == {} and a.to_prom_text() == "" and not a.events


def test_disabled_registry_and_runtime_are_null():
    reg = obs.MetricsRegistry(enabled=False)
    reg.counter("x").inc(5)
    reg.gauge("g").set(1)
    reg.histogram("h").observe(1.0)
    reg.histogram("h").observe_many([1.0, 2.0])
    reg.log_event("e", a=1)
    assert reg.snapshot() == {} and reg.value("x") == 0.0 and not reg.events
    assert reg.counter("x") is reg.counter("y")
    try:
        rt = obs.configure(obs.ObsConfig(enabled=False))
        s1, s2 = obs.span("step", epoch=0), obs.span("sample")
        assert s1 is s2 is obs._NULL_SPAN
        with s1:
            pass
        assert obs.phase_seconds("step") == 0.0 and obs.flush() == []
        assert not rt.tracer.enabled
        # on by default: the counters, not the tracer
        rt = obs.configure()
        with obs.span("step", epoch=1, step=2):
            pass
        obs.set_gauge("g", 2.5, layer=1)
        assert obs.phase_seconds("step") > 0.0
        assert rt.registry.value("phase_calls", phase="step") == 1.0
        assert rt.registry.value("g", layer=1) == 2.5
        assert not rt.tracer.events
    finally:
        obs.configure()


def traced(o):
    """Spans on the main thread (nested, with args) and on two worker
    threads, a modeled span and a counter event, exported."""
    tr = o.Tracer(enabled=True, rank=3)
    import time

    def span(name, **args):
        tr.push(name)
        t0 = time.perf_counter()
        return lambda: tr.record(name, t0, time.perf_counter(), args=args)

    end_step = span("step", epoch=0, step=4)
    end_fwd = span("fwd")
    end_fwd()
    end_step()

    both = threading.Barrier(2)        # both alive: two thread idents

    def worker():
        both.wait()
        span("sample", epoch=0, step=5)()
        span("host_prep")()
        both.wait()
    ts = [threading.Thread(target=worker, name=f"prefetch-{i}")
          for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    tr.add_complete("aep_push", 0.001, 0.002, track="modeled")
    tr.counter_event("queue", 0.003, {"depth": 2})
    return tr, tr.export()


def test_tracer_export_passes_both_validators():
    tr, trace = traced(obs)
    n = obs.validate_chrome_trace(trace)
    assert n == j_obs.validate_chrome_trace(trace) == 7
    spans = {e["name"]: e for e in trace["traceEvents"] if e["ph"] == "X"}
    fwd, step = spans["fwd"], spans["step"]
    assert fwd["args"] == {"depth": 1, "parent": "step"}
    assert step["args"] == {"epoch": 0, "step": 4, "depth": 0}
    assert fwd["tid"] == step["tid"]
    assert step["ts"] <= fwd["ts"] and \
        fwd["ts"] + fwd["dur"] <= step["ts"] + step["dur"]
    names = {e["tid"]: e["args"]["name"] for e in trace["traceEvents"]
             if e["ph"] == "M"}
    tids = {e["tid"] for e in trace["traceEvents"]
            if e["ph"] == "X" and e["name"] in ("sample", "host_prep")}
    assert len(tids) == 2 and {names[t] for t in tids} == {"prefetch-0",
                                                           "prefetch-1"}
    assert all(e["pid"] == 3 for e in trace["traceEvents"])
    # the reference's tracer gives the same event structure
    _, jtrace = traced(j_obs)
    shape = lambda t: sorted(  # noqa: E731
        json.dumps([e["name"], e["ph"], e.get("args")])
        for e in t["traceEvents"]
        if e["ph"] != "X" or e["name"] == "aep_push")
    assert shape(trace) == shape(jtrace)
    with pytest.raises(ValueError):
        obs.validate_chrome_trace({"traceEvents": [{"name": "x", "ph": "Q",
                                                    "pid": 0, "tid": 0}]})
    tr.reset()
    assert tr.export()["traceEvents"] == []


HISTORY = [dict(t_sample=3.25, t_host_prep=0.5, t_stage=0.125, t_step=0.875,
                t_wall=3.5),
           dict(t_sample=2.0, t_host_prep=0.25, t_stage=0.0625, t_step=1.0),
           dict()]


@pytest.mark.parametrize("model", ["none", "roofline", "exposed"])
def test_epoch_breakdown_matches_reference(model):
    kw = {"none": None,
          "roofline": dict(flops=4e12, bytes_accessed=2e11, push_bytes=1e9,
                           peak_flops=6.7e13, hbm_bw=3.35e12, ici_bw=1e11),
          "exposed": dict(flops=1e9, bytes_accessed=1e9, push_bytes=5e10,
                          peak_flops=6.7e13, hbm_bw=3.35e12, ici_bw=1e11)
          }[model]
    a = obs.StepModel.from_roofline(**kw) if kw else None
    b = j_obs.StepModel.from_roofline(**kw) if kw else None
    if kw:
        assert a.overlap_efficiency() == b.overlap_efficiency()
        assert a.split_step(0.3) == b.split_step(0.3)
        assert (a.overlap_efficiency() < 1.0) == (model == "exposed")
    ba = obs.EpochBreakdown.from_history(HISTORY, a)
    bb = j_obs.EpochBreakdown.from_history(HISTORY, b)
    assert ba.rows() == bb.rows()
    assert ba.table() == bb.table()
    for row in ba.rows()[:2]:
        assert sum(row[f"share_{k}"] for k in ("sample", "host_prep", "h2d",
                                               "fwd", "aep_push", "bwd")) \
            == pytest.approx(1.0)
    assert obs.MEASURED_PHASES == j_obs.MEASURED_PHASES
    assert obs.REPORT_PHASES == j_obs.REPORT_PHASES


def test_prom_file_writer(tmp_path):
    reg = drive(obs)
    path = tmp_path / "sub" / "m.prom"
    w = obs.PromFileWriter(str(path), min_interval_s=3600.0)
    assert w.maybe_write(reg) == str(path) and w.writes == 1
    assert w.maybe_write(reg) is None and w.writes == 1
    assert path.read_text() == reg.to_prom_text()
    jw = j_obs.PromFileWriter(str(tmp_path / "j.prom"))
    jw.write(drive(j_obs))
    assert (tmp_path / "j.prom").read_text() == path.read_text()
    assert not list((tmp_path / "sub").glob("*.tmp.*"))


# ---------------------------------------------------------------------------
# the device trace's arithmetic (the card's own test is in test_torch_cuda)
# ---------------------------------------------------------------------------
def ev(stream, ts, dur, cat="device_kernel"):
    return {"name": f"k{stream}", "cat": cat, "stream": stream, "ts": ts,
            "dur": dur}


def test_busy_share_is_the_union_of_two_overlapping_streams():
    """Stream 7 busy [0, 60] and [70, 100], stream 13 [50, 90] and a copy
    on stream 20 [95, 120]: the per-op sum (155 µs) would read 129% of
    the 120 µs window; the union reads 120 µs = 100%, and 110 µs within
    [0, 110]."""
    events = [ev(7, 0, 60), ev(7, 70, 30), ev(13, 50, 40),
              ev(20, 95, 25, "device_memcpy")]
    assert sum(e["dur"] for e in events) == 155
    assert obs.busy_us(events) == 120
    assert obs.busy_us(events, [(0, 110)]) == 110
    assert obs.busy_us(events, [(0, 50), (40, 80)]) == 80
    assert obs.stream_overlap_us(events, 13, [7]) == 30
    assert obs.stream_overlap_us(events, 20, [7, 13]) == 5
    s = obs.device_summary(events, [(0, 120)])
    assert s["busy_share"] == 1.0 and s["wall_us"] == 120
    assert s["streams"][7] == {"device_us": 90, "kernels": 2, "memcpys": 0,
                               "overlap_us": 35}
    assert s["streams"][20]["memcpys"] == 1
    assert [t["name"] for t in s["top"]][:1] == ["k7"]
    s = obs.device_summary(events, [(0, 240)])
    assert s["busy_share"] == 0.5
    # a trace written by the tracer reads back the same events
    tr = obs.Tracer(enabled=True)
    for e in events:
        tr.add_complete(e["name"], e["ts"] / 1e6, e["dur"] / 1e6,
                        track=f"cuda stream {e['stream']}", cat=e["cat"],
                        args={"stream": e["stream"]})
    back = obs.device_events(tr.export())
    assert obs.busy_us(back) == pytest.approx(120)
    assert {e["stream"] for e in back} == {7, 13, 20}


def test_device_trace_records_nothing_on_the_cpu():
    tr = obs.Tracer(enabled=True)
    with obs.DeviceTrace("cpu", tr) as dt:
        sum(range(1000))
    assert dt.events == [] and tr.events == []
    s = dt.summary()
    assert s["busy_us"] == 0.0 and s["wall_us"] > 0.0


# ---------------------------------------------------------------------------
# the three launchers' files
# ---------------------------------------------------------------------------
def check_files(tmp_path, phases):
    trace = json.loads((tmp_path / "t.json").read_text())
    assert obs.validate_chrome_trace(trace) > 0
    assert j_obs.validate_chrome_trace(trace) > 0
    lines = (tmp_path / "m.jsonl").read_text().splitlines()
    rows = [json.loads(line) for line in lines]
    assert rows and all("metric" in r or "event" in r for r in rows)
    prom = (tmp_path / "p.prom").read_text()
    for p in phases:
        assert f'phase_seconds{{phase="{p}"}}' in prom
    return trace


def flags(tmp_path):
    return ["--device", "cpu", "--trace-out", str(tmp_path / "t.json"),
            "--metrics-out", str(tmp_path / "m.jsonl"),
            "--prom-out", str(tmp_path / "p.prom")]


def test_train_launcher_writes_obs_files(tmp_path):
    from repro_torch.launch import train
    try:
        res = train.run_gnn(train.parse_args(
            ["gnn", "--ranks", "2", "--vertices", "1200", "--epochs", "1",
             "--batch", "64"] + flags(tmp_path)))
        trace = check_files(tmp_path, PHASES)
        ev_ = [e for e in trace["traceEvents"] if e["ph"] == "X"]
        tid = {e["name"]: e["tid"] for e in ev_}
        assert tid["sample"] == tid["host_prep"] != tid["step"] == \
            tid["stage"]
        assert all("epoch" in e["args"] and "step" in e["args"]
                   for e in ev_ if e["name"] in ("sample", "step"))
        prom = (tmp_path / "p.prom").read_text()
        assert 'train_epochs_total{sampler_policy="uniform"} 1.0' in prom
        assert res["device_trace"] == {}      # no card: not measured
        bd = obs.EpochBreakdown.from_history(res["history"])
        assert len(bd.rows()) == 1 and "epoch" in bd.table()
    finally:
        obs.configure()


def test_serve_launcher_writes_obs_files(tmp_path):
    from repro_torch.launch import gnn_serve
    try:
        gnn_serve.run(gnn_serve.parse_args(
            ["--vertices", "600", "--queries", "48", "--slots", "8"]
            + flags(tmp_path)))
        check_files(tmp_path, ("serve_round", "serve_sample", "serve_step"))
    finally:
        obs.configure()


def test_sharded_serve_launcher_writes_obs_files(tmp_path):
    from repro_torch.launch import gnn_serve_dist
    try:
        res = gnn_serve_dist.run(gnn_serve_dist.parse_args(
            ["--vertices", "800", "--queries", "48", "--slots", "8",
             "--ranks", "2", "--cache-size", "4096", "--hot-size", "64"]
            + flags(tmp_path)))
        check_files(tmp_path, ("serve_round", "serve_sample", "serve_step"))
        assert res["device_trace"] == {}
    finally:
        obs.configure()
