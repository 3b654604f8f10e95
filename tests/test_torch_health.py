"""The port's cluster health plane against the reference, on the CPU.

The same numpy inputs go through ``repro.obs`` and ``repro_torch.obs``:
``RankAccumulator`` totals and the published series, ``skew_ratio``, the
six detectors' firing sequences and ``Detection`` payloads, the flight
recorder's bound and dump, ``HealthPlane``'s detections and gauges,
``ExchangePlan.expected_inbound_rows`` and the offline exchange's rank
series, all exact.  One reference subprocess with four forced host
devices (as ``tests/test_torch_modes.py`` runs its trainer) records the
reference trainer's per-rank ``rank_stats`` for 3 steps at R=1 and R=4
in ``aep`` (with and without the hot tier, and GAT at R=4) and in
``sync``, its state after them and ``DistTrainer.audit`` of that state;
the port's ``rank_stats`` must equal them exactly, and the port's audit
of the same state (loaded into the port) must give the same sampled
entries and errors within 1e-5.  The port against itself: training and
serving give the same bits with the planes off or on, and a step copies
its metrics and rank series to the host once.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.comm.engine import HaloExchangeEngine as JEngine
from repro.comm.plan import build_exchange_plan as j_plan
from repro.graph import partition_graph as j_partition_graph
from repro.graph import synthetic_graph as j_synthetic_graph
from repro_torch import obs
from repro_torch.comm.engine import HaloExchangeEngine
from repro_torch.comm.plan import build_exchange_plan
from repro_torch.configs.gnn import HECConfig, small_gnn_config
from repro_torch.graph import partition_graph, synthetic_graph
from repro_torch.pipeline.prefetcher import SamplingPlan
from repro_torch.train.gnn_trainer import (DistTrainer, build_dist_data,
                                           minibatch_to_device)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
STEPS = 3
SAMPLES = 48                    # audit samples per layer
RUNS = [("aep", "graphsage", 1), ("aep", "graphsage", 4),
        ("hot", "graphsage", 4), ("sync", "graphsage", 1),
        ("sync", "graphsage", 4), ("aep", "gat", 4)]
HOT = dict(hot_size=48, hot_budget=32)
PARAM_NAMES = {"graphsage": ("wn", "ws", "b"),
               "gat": ("w", "b", "a_u", "a_v")}


@pytest.fixture(autouse=True)
def fresh_obs():
    obs.configure()
    jobs.configure()
    yield
    obs.configure()
    jobs.configure()


# ---------------------------------------------------------------------------
# aggregation, detectors, recorder, plane: the same inputs, exact
# ---------------------------------------------------------------------------
def test_rank_accumulator_and_series_match_reference():
    R = 4
    rng = np.random.default_rng(0)
    shards = [{"rank_halo_rows": rng.integers(0, 100, R).astype(np.float64),
               "rank_examples": rng.integers(1, 32, R).astype(np.float32)}
              for _ in range(7)]
    got, want = obs.RankAccumulator(R), jobs.RankAccumulator(R)
    for s in shards:
        got.add(s)
        want.add(s)
    assert got.steps == want.steps == 7
    gt, wt = got.finish(), want.finish()
    assert sorted(gt) == sorted(wt)
    for k in gt:
        assert np.array_equal(gt[k], wt[k]) and gt[k].dtype == wt[k].dtype
    reg, jreg = obs.MetricsRegistry(), jobs.MetricsRegistry()
    gv, wv = obs.publish_rank_series(reg, gt), jobs.publish_rank_series(
        jreg, wt)
    for k in gv:
        assert (gv[k].sum, gv[k].mean, gv[k].max, gv[k].skew) == \
            (wv[k].sum, wv[k].mean, wv[k].max, wv[k].skew)
    assert reg.snapshot() == jreg.snapshot()
    assert np.array_equal(obs.rank_series(reg, "rank_halo_rows", R),
                          jobs.rank_series(jreg, "rank_halo_rows", R))
    assert obs.rank_series(reg, "missing", R) is None
    with pytest.raises(ValueError):
        obs.RankAccumulator(3).add({"x": np.zeros(4)})


@pytest.mark.parametrize("v", [[], [0, 0], [1, 2, 3], [5.0], [0, 7, 1]])
def test_skew_ratio_matches_reference(v):
    assert obs.skew_ratio(v) == jobs.skew_ratio(v)


def detector_trace(seed, n=40, R=4):
    """Per-window inputs with planted stragglers, skew, drift, fat tails,
    hot-rate collapses, audit breaches and empty windows."""
    rng = np.random.default_rng(seed)
    out = []
    for w in range(n):
        t = rng.uniform(0.9, 1.1, R)
        if 5 <= w < 12:
            t[2] *= 3.0
        if w in (20, 21):
            t[:] = 0.0
        halo = rng.integers(50, 60, R).astype(np.float64)
        if 8 <= w < 16:
            halo[1] *= 9.0
        if w == 30:
            halo[:] = 0.0
        hot = halo.sum() * (0.4 if w < 18 else 0.05)
        lat = rng.exponential(0.01, 30 if w % 7 else 10)
        if 22 <= w < 26:
            lat *= 10.0
        err = None if w % 5 == 0 else (0.3 if 25 <= w < 33 else 0.01)
        out.append((t, halo, hot, lat, err))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detectors_fire_as_the_reference(seed):
    """The six detectors fed the same windows: the same detections (every
    field) at the same windows, and the same running values."""
    pairs = [
        (obs.StragglerDetector(2.0, 3), jobs.StragglerDetector(2.0, 3)),
        (obs.LoadSkewDetector(1.5, 3), jobs.LoadSkewDetector(1.5, 3)),
        (obs.EdgeCutDriftDetector([10, 10, 10, 10], 0.2, 3),
         jobs.EdgeCutDriftDetector([10, 10, 10, 10], 0.2, 3)),
        (obs.SLOBurnDetector(0.05, 0.05, 2, 20),
         jobs.SLOBurnDetector(0.05, 0.05, 2, 20)),
        (obs.HotTierDecayDetector(0.5, 3), jobs.HotTierDecayDetector(0.5, 3)),
        (obs.QualityBudgetDetector(0.1, 2), jobs.QualityBudgetDetector(0.1, 2)),
    ]
    fired = 0
    for w, (t, halo, hot, lat, err) in enumerate(detector_trace(seed)):
        h, jh = obs.Histogram(), jobs.Histogram()
        h.observe_many(lat)
        jh.observe_many(lat)
        args = [(t,), (halo,), (halo,), (h, jh), (hot, halo.sum()), (err,)]
        for (a, b), arg in zip(pairs, args):
            if isinstance(a, obs.SLOBurnDetector):
                got, want = a.update(w, arg[0]), b.update(w, arg[1])
            else:
                got, want = a.update(w, *arg), b.update(w, *arg)
            assert [d.to_json() for d in got] == [d.to_json() for d in want]
            fired += len(got)
            for attr in ("last_skew", "last_drift", "last_burn", "last_rate",
                         "last_err", "peak"):
                assert getattr(a, attr, None) == getattr(b, attr, None)
    assert fired >= 5


def strip_times(x):
    """A recorder payload without its clock readings."""
    if isinstance(x, dict):
        return {k: strip_times(v) for k, v in x.items()
                if k not in ("t_s", "created_unix")}
    if isinstance(x, list):
        return [strip_times(v) for v in x]
    return x


def test_flight_recorder_matches_reference(tmp_path):
    """Bounded to its capacity, the same entries and metric deltas, and
    the same dump (clock readings aside)."""
    got, want = obs.FlightRecorder(5), jobs.FlightRecorder(5)
    reg, jreg = obs.MetricsRegistry(), jobs.MetricsRegistry()
    for i in range(9):
        for rec, r in ((got, reg), (want, jreg)):
            r.counter("c", k=i % 3).inc(i)
            r.gauge("g").set(float(i) / 3)
            rec.note("window", epoch=i, totals={"x": [i, i + 1]})
            rec.record_metrics_delta(r)
    assert len(got.entries) == 5
    assert strip_times(list(got.entries)) == strip_times(list(want.entries))
    a = got.dump("edge cut/drift!", str(tmp_path / "a"), extra={"k": 1})
    b = want.dump("edge cut/drift!", str(tmp_path / "b"), extra={"k": 1})
    assert os.path.basename(a) == os.path.basename(b) == \
        "FLIGHT_edge_cut_drift.json"
    assert strip_times(json.load(open(a))) == strip_times(json.load(open(b)))


def test_health_plane_matches_reference(tmp_path):
    """Windows with planted skew, drift, hot decay and a fat latency tail,
    and audits over budget: the same detections, gauges, summary and
    flight files, and the guard dumps an escaped exception."""
    R = 4
    planes = []
    for mod, d in ((obs, "port"), (jobs, "ref")):
        reg = mod.MetricsRegistry()
        cfg = mod.HealthConfig(flight_dir=str(tmp_path / d),
                               skew_threshold=1.5, slo_p99_s=0.05,
                               quality_budget=0.1)
        planes.append((mod.HealthPlane(cfg, num_ranks=R,
                                       expected_halo_rows=[10] * R,
                                       registry=reg), reg))
    (p, reg), (q, jreg) = planes
    for w, (t, halo, hot, lat, err) in enumerate(detector_trace(3)):
        totals = {"rank_step_seconds": t, "rank_halo_rows": halo,
                  "rank_hot_hits": np.full(R, hot / R)}
        hists = []
        for mod in (obs, jobs):
            h = mod.Histogram()
            h.observe_many(lat)
            hists.append(h)
        a = p.observe_epoch(totals, wall_s=1.0, latency_hist=hists[0])
        b = q.observe_round(totals, wall_s=1.0, latency_hist=hists[1])
        assert [d.to_json() for d in a] == [d.to_json() for d in b]
        assert [d.to_json() for d in p.observe_audit(w, err)] == \
            [d.to_json() for d in q.observe_audit(w, err)]
    assert reg.snapshot() == jreg.snapshot()
    sp, sq = p.summary(), q.summary()
    assert [os.path.basename(f) for f in sp.pop("flight_paths")] == \
        [os.path.basename(f) for f in sq.pop("flight_paths")]
    assert sp == sq and sp["detections"]
    for f in os.listdir(tmp_path / "port"):
        assert strip_times(json.load(open(tmp_path / "port" / f))) == \
            strip_times(json.load(open(tmp_path / "ref" / f)))
    with pytest.raises(RuntimeError):
        with p.guard("loop"):
            raise RuntimeError("boom")
    dump = json.load(open(p.flight_paths[-1]))
    assert dump["exception"]["type"] == "RuntimeError"
    off = obs.HealthPlane(obs.HealthConfig(enabled=False))
    assert off.observe_epoch({"rank_halo_rows": np.ones(1)}) == []


def test_expected_inbound_rows_and_exchange_series_match_reference():
    """The plan's inbound rows (= each rank's halo count) and the offline
    exchange's per-rank received rows and bytes, published as series."""
    kw = dict(num_vertices=900, avg_degree=8, num_classes=4, feat_dim=8,
              seed=2)
    ps = partition_graph(synthetic_graph(**kw), 4, seed=0)
    jps = j_partition_graph(j_synthetic_graph(**kw), 4, seed=0)
    got = build_exchange_plan(ps).expected_inbound_rows()
    want = j_plan(jps).expected_inbound_rows()
    assert np.array_equal(got, want) and got.dtype == want.dtype
    assert np.array_equal(got, [p.num_halo for p in ps.parts])
    rng = np.random.default_rng(0)
    h = [rng.normal(size=(p.num_solid, 6)).astype(np.float32)
         for p in ps.parts]
    rows, nb = HaloExchangeEngine.from_partition(ps).exchange_halos_host(
        [torch.as_tensor(x) for x in h])
    jrows, jnb = JEngine.from_partition(jps).exchange_halos_host(h)
    assert nb == jnb
    for a, b in zip(rows, jrows):
        assert np.array_equal(a.numpy(), b)
    reg, jreg = obs.get().registry, jobs.get().registry
    for name in ("rank_exchange_rows", "rank_exchange_bytes"):
        assert np.array_equal(obs.rank_series(reg, name, 4),
                              jobs.rank_series(jreg, name, 4))
        assert reg.value("cluster_sum", metric=name) == \
            jreg.value("cluster_sum", metric=name)


# ---------------------------------------------------------------------------
# the trainer: rank series and audit against the reference
# ---------------------------------------------------------------------------
_REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh
from repro import obs
from repro.configs.gnn import HECConfig, small_gnn_config
from repro.graph import partition_graph, synthetic_graph
from repro.pipeline.staging import MinibatchPipeline
from repro.train.gnn_trainer import DistTrainer, build_dist_data

STEPS, SAMPLES = int(sys.argv[2]), int(sys.argv[3])
RUNS = [r.split(":") for r in sys.argv[4].split(",")]
out = {}
g = synthetic_graph(num_vertices=1500, avg_degree=8, num_classes=6,
                    feat_dim=24, seed=0)


def batches(pipe):
    ep = 0
    while True:
        yield from pipe.epoch_batches(ep)
        ep += 1


for mode, model, R in RUNS:
    R = int(R)
    hot = {"hot_size": 48, "hot_budget": 32} if mode == "hot" else {}
    cfg = small_gnn_config(model, batch_size=32, feat_dim=24, num_classes=6,
                           hec=HECConfig(cache_size=4096, ways=4,
                                         life_span=2, push_limit=256,
                                         delay=1, **hot))
    ps = partition_graph(g, R, seed=0)
    dd = build_dist_data(ps, cfg)
    mesh = Mesh(np.array(jax.devices()[:R]), ("data",))
    q = obs.QualityPlane(obs.QualityConfig(audit_interval=1,
                                           audit_samples=SAMPLES, seed=0))
    tr = DistTrainer(cfg=cfg, mesh=mesh, num_ranks=R,
                     mode="aep" if mode == "hot" else mode, quality=q)
    st = tr.init_state(jax.random.key(0), dd)
    pre = f"{mode}/{model}/r{R}"
    step_fn = tr.make_step(dd, donate=False)
    pipe = MinibatchPipeline(ps, cfg, base_seed=0, mesh=mesh)
    for i, mb in zip(range(STEPS), batches(pipe)):
        (st["params"], st["opt_state"], st["hec"], st["hot"],
         st["inflight"], rank_stats, _) = step_fn(
            st["params"], st["opt_state"], st["hec"], st["hot"],
            st["inflight"], dd, mb, jnp.uint32(i))
        for k, v in rank_stats.items():
            out[f"{pre}/rs/{i}/{k}"] = np.asarray(v)
    for l, layer in enumerate(st["params"]["layers"]):
        for n, v in layer.items():
            out[f"{pre}/params/{l}/{n}"] = np.asarray(v)
    for l, h in enumerate(st["hec"]):
        for f in ("tags", "age", "values"):
            out[f"{pre}/hec_{f}/{l}"] = np.asarray(getattr(h, f))
    for l, h in enumerate(st["hot"]):
        for f in ("age", "values"):
            out[f"{pre}/hot_{f}/{l}"] = np.asarray(getattr(h, f))
    rep = tr.audit(ps, dd, st, epoch=2)
    out[f"{pre}/audit"] = np.frombuffer(
        __import__("json").dumps(rep.to_json()).encode(), np.uint8)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    runs = ",".join(f"{m}:{model}:{R}" for m, model, R in RUNS)
    proc = subprocess.run([sys.executable, "-c", _REF_SCRIPT, str(path),
                           str(STEPS), str(SAMPLES), runs],
                          env=env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


def graph():
    return synthetic_graph(num_vertices=1500, avg_degree=8, num_classes=6,
                           feat_dim=24, seed=0)


def config(model, hot=False):
    return small_gnn_config(model, batch_size=32, feat_dim=24, num_classes=6,
                            hec=HECConfig(cache_size=4096, ways=4,
                                          life_span=2, push_limit=256,
                                          delay=1, **(HOT if hot else {})))


def setup(mode, model, R, **planes):
    ps = partition_graph(graph(), R, seed=0)
    cfg = config(model, mode == "hot")
    tr = DistTrainer(cfg, R, mode="aep" if mode == "hot" else mode,
                     device=CPU, **planes)
    data = build_dist_data(ps, cfg, CPU)
    return ps, cfg, tr, data


def first_batches(ps, cfg, n=STEPS):
    plan = SamplingPlan(ps, cfg, 0)
    return [h for ep in range(2)
            for h in plan.batches(plan.epoch_schedule(ep), ep)][:n]


@pytest.mark.parametrize("mode,model,R", RUNS)
def test_rank_series_match_reference(reference_run, mode, model, R):
    """Every step's per-rank series (examples, sampled rows, halo rows,
    HEC and hot hits, pushed rows and bytes) equal the reference's."""
    ps, cfg, tr, data = setup(mode, model, R)
    st = tr.init_state(seed=0, dist_data=data)
    pre = f"{mode}/{model}/r{R}"
    for i, h in enumerate(first_batches(ps, cfg)):
        tr.train_step(st, data, minibatch_to_device(h, CPU), i)
        want = {k.rsplit("/", 1)[1]: v for k, v in reference_run.items()
                if k.startswith(f"{pre}/rs/{i}/")}
        assert sorted(tr.rank_stats) == sorted(want)
        for k, v in want.items():
            assert np.array_equal(tr.rank_stats[k], v.astype(np.float64)), k


def load_reference_state(st, ref, pre, model):
    """The reference's parameters, HECs and hot tier into the port's
    state."""
    t = torch.as_tensor
    with torch.no_grad():
        for l, layer in enumerate(st["model"].layers):
            for n in PARAM_NAMES[model]:
                getattr(layer, n).copy_(t(ref[f"{pre}/params/{l}/{n}"]))
        for l, layer in enumerate(st["hec"]):
            for r, s in enumerate(layer):
                for f in ("tags", "age", "values"):
                    getattr(s, f).copy_(t(ref[f"{pre}/hec_{f}/{l}"][r]))
        for l, s in enumerate(st["hot"]):
            for f in ("age", "values"):
                getattr(s, f).copy_(t(ref[f"{pre}/hot_{f}/{l}"]))


@pytest.mark.parametrize("mode,model,R", RUNS)
def test_audit_matches_reference(reference_run, mode, model, R):
    """The port's audit of the reference's state after 3 steps: the same
    entries sampled per layer (and hot replicas), errors within 1e-5."""
    q = obs.QualityPlane(obs.QualityConfig(audit_interval=1,
                                           audit_samples=SAMPLES, seed=0))
    ps, cfg, tr, data = setup(mode, model, R, quality=q)
    st = tr.init_state(seed=0, dist_data=data)
    pre = f"{mode}/{model}/r{R}"
    load_reference_state(st, reference_run, pre, model)
    got = tr.audit(ps, data, st, epoch=2).to_json()
    want = json.loads(reference_run[f"{pre}/audit"].tobytes())
    assert got["epoch"] == want["epoch"] and got["source"] == "train"
    assert sorted(got["layers"]) == sorted(want["layers"])
    for l in want["layers"]:
        a, b = got["layers"][l], want["layers"][l]
        # sync mode pushes nothing and one rank has no halo: empty HECs
        assert a["n"] == b["n"] and (b["n"] > 0) == (R > 1 and mode != "sync")
        assert sorted(a) == sorted(b) and a.get("age_mean") == \
            b.get("age_mean")
        for k in ("err_mean", "err_p99", "err_max"):
            if k in b:
                assert abs(a[k] - b[k]) <= 1e-5, (l, k)
    assert (got["hot"] is None) == (want["hot"] is None) == (mode != "hot")
    if want["hot"]:
        assert got["hot"]["n"] == want["hot"]["n"]
        assert abs(got["hot"]["err_mean"] - want["hot"]["err_mean"]) <= 1e-5
    if R == 1 or mode == "sync":              # nothing cached
        assert got["mean_err"] is want["mean_err"] is None
        return
    assert abs(got["mean_err"] - want["mean_err"]) <= 1e-5
    assert float(got["layers"]["0"]["err_max"]) == 0.0   # raw features


def run_epochs(planes: bool, tmp_path, model="graphsage", epochs=2):
    """Two epochs of a 4-rank aep trainer with the hot tier, with both
    planes (audit every epoch) or none."""
    kw = {}
    if planes:
        health = obs.HealthPlane(obs.HealthConfig(
            flight_dir=str(tmp_path), quality_budget=1e-9), num_ranks=4,
            expected_halo_rows=[1, 1, 1, 1])
        kw = dict(health=health, quality=obs.QualityPlane(
            obs.QualityConfig(audit_interval=1, audit_samples=32),
            health=health))
    ps, cfg, tr, data = setup("hot", model, 4, **kw)
    st = tr.init_state(seed=0, dist_data=data)
    calls = {"cpu": 0, "float": 0}
    cpu, flt = torch.Tensor.cpu, torch.Tensor.__float__

    def count_cpu(self, *a, **k):
        calls["cpu"] += 1
        return cpu(self, *a, **k)

    def count_float(self):
        calls["float"] += 1
        return flt(self)
    step = tr.train_step

    def counted(*a, **k):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch.Tensor, "cpu", count_cpu)
            mp.setattr(torch.Tensor, "__float__", count_float)
            return step(*a, **k)
    tr.train_step = counted
    st, hist = tr.train_epochs(ps, data, st, epochs, pipeline=None)
    tensors = [p.detach().clone() for p in st["model"].parameter_list()]
    tensors += [getattr(s, f).clone() for layer in st["hec"] for s in layer
                for f in ("tags", "age", "values")]
    tensors += [getattr(s, f).clone() for s in st["hot"]
                for f in ("age", "values")]
    tensors += [q[k].clone() for q in st["inflight"] for k in sorted(q)]
    return tr, hist, tensors, calls


def test_training_bit_identical_with_planes_on_or_off(tmp_path):
    """Both planes on (an audit every epoch, a budget that fires) or off:
    the same step metrics, history losses, parameters, HEC and tier
    state and queues, bit for bit; every step copies to the host once
    either way, and reads no tensor with ``float``."""
    on, h_on, s_on, c_on = run_epochs(True, tmp_path)
    off, h_off, s_off, c_off = run_epochs(False, tmp_path)
    steps = len(on.step_log)
    assert on.step_log == off.step_log and steps > 0
    assert [h["loss"] for h in h_on] == [h["loss"] for h in h_off]
    assert all(torch.equal(a, b) for a, b in zip(s_on, s_off))
    assert c_on == c_off == {"cpu": steps, "float": 0}
    assert on.quality.audits_run == 2 and on.health.summary()["windows"] == 2
    assert any(d.reason == "quality" for d in on.health.detections)
    assert os.path.exists(tmp_path / "FLIGHT_quality.json")


def test_train_epochs_publishes_rank_series(tmp_path):
    """The epoch's rank series land in the registry as rank-labeled
    counters whose sum is the cluster view, and sum the step series."""
    tr, hist, _, _ = run_epochs(True, tmp_path, epochs=1)
    reg = obs.get().registry
    for name in ("rank_examples", "rank_halo_rows", "rank_hec_hits",
                 "rank_hot_hits", "rank_push_rows", "rank_push_bytes",
                 "rank_sample_rows", "rank_step_seconds"):
        series = obs.rank_series(reg, name, 4)
        assert series is not None, name
        assert reg.value("cluster_sum", metric=name) == float(series.sum())
    ex = obs.rank_series(reg, "rank_examples", 4).sum()
    assert ex == sum(m["examples"] for m in tr.step_log)
    push = obs.rank_series(reg, "rank_push_rows", 4).sum()
    assert push == sum(m["aep_push_rows"] for m in tr.step_log)
    gauges = reg.snapshot()
    assert any(k.startswith("hec_stale_age_mean_l") for k in gauges)
    assert any(k.startswith("hot_refresh_lag_l") for k in gauges)
