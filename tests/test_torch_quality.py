"""The port's embedding quality plane against the reference, on the CPU.

The same numpy inputs go through ``repro.obs.quality`` and
``repro_torch.obs.quality``: ``relative_l2``, the cache reads
(``valid_ages``, ``cache_entries`` with and without sampling, a stacked
state or the trainer's per-rank list), the staleness histograms, the
hot tier's replica ages and ``run_audit``'s ``AuditReport``, exactly.
Single-rank serving against the reference scheduler: the cold cache's
audit samples the same lines (same vids and ages) and scores them
within 1e-5, and a cache warmed from the offline rows audits to exactly
0.0 on both.  The reference's sharded scheduler cannot run here (the
jax vmap caveat, ``ROADMAP.md``), so the port's sharded planes are held
to that scheduler's own contract: fresh shards audit to exactly 0.0,
answers are bit-equal with the planes off or on, and the rank series sum
to the cluster's counters.  The launchers' plane flags: a cold audit, a
warm one of 0.0, an SLO burn that dumps ``FLIGHT_slo_burn.json``.
"""
import json
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.cache import hec as j_hec
from repro.cache import hot_tier as j_hot
from repro.obs import quality as j_quality
from repro.serve.gnn import GNNServeConfig as JServeConfig
from repro.serve.gnn import GNNServeScheduler as JScheduler
from repro.serve.gnn import ServeCacheConfig as JCacheConfig
from repro.serve.gnn import layerwise_embeddings as j_layerwise
from repro.serve.gnn import warm_cache as j_warm
from repro_torch import obs
from repro_torch.cache import hec
from repro_torch.cache import hot_tier
from repro_torch.graph import partition_graph, synthetic_graph
from repro_torch.models.gnn import build_model
from repro_torch.obs import quality
from repro_torch.serve.gnn import (GNNServeConfig, GNNServeScheduler,
                                   ServeCacheConfig, layerwise_embeddings,
                                   warm_cache)
from repro_torch.serve.gnn.distributed import (DistGNNServeScheduler,
                                               DistServeConfig,
                                               layerwise_embeddings_dist)
from test_torch_serving import configs, graphs, models

t = torch.as_tensor


@pytest.fixture(autouse=True)
def fresh_obs():
    obs.configure()
    jobs.configure()
    yield
    obs.configure()
    jobs.configure()


# ---------------------------------------------------------------------------
# helpers against the reference on the same inputs
# ---------------------------------------------------------------------------
def test_relative_l2_matches_reference():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(50, 9)).astype(np.float32)
    b = a + rng.normal(size=a.shape).astype(np.float32) * 1e-3
    b[:5] = a[:5]                                   # bit-equal rows
    b[5:8] = 0.0                                    # zero exact rows
    got, want = quality.relative_l2(a, b), j_quality.relative_l2(a, b)
    assert np.array_equal(got, want) and (got[:5] == 0.0).all()


def filled(R, nsets=16, ways=4, d=6, seed=0):
    """R caches with the same stores and ticks, port and reference."""
    rng = np.random.default_rng(seed)
    ports, refs = [], []
    for r in range(R):
        st = hec.hec_init(nsets * ways, ways, d, torch.device("cpu"))
        js = j_hec.hec_init(nsets * ways, ways, d)
        for k in range(4):
            v = rng.integers(0, 400, 40).astype(np.int32)
            e = rng.normal(size=(40, d)).astype(np.float32)
            hec.hec_store(st, t(v), t(e))
            js = j_hec.hec_store(js, jnp.asarray(v), jnp.asarray(e))
            if k % 2:
                hec.hec_tick(st, 3)
                js = j_hec.hec_tick(js, 3)
        ports.append(st)
        refs.append(js)
    stacked = SimpleNamespace(**{f: jnp.stack([getattr(s, f) for s in refs])
                                 for f in ("tags", "age", "values")})
    return ports, refs, stacked


@pytest.mark.parametrize("sample", [None, 7, 1000])
def test_cache_reads_match_reference(sample):
    """``valid_ages``, ``cache_entries``/``hec_entries`` (sampled from the
    same generator) and ``EmbeddingCache.cached_entries``: one state, and
    the trainer's per-rank list against the reference's stacked state."""
    ports, refs, stacked = filled(3)
    cases = [(ports[0], refs[0]), (ports, stacked)]
    for p, r in cases:
        assert np.array_equal(quality.valid_ages(p), j_quality.valid_ages(r))
        assert np.array_equal(hec.hec_valid_ages(p), j_hec.hec_valid_ages(r))
        got = hec.hec_entries(p, sample=sample,
                              rng=np.random.default_rng(4))
        want = j_hec.hec_entries(r, sample=sample,
                                 rng=np.random.default_rng(4))
        for a, b in zip(got, want):
            assert np.array_equal(a, b) and a.dtype == b.dtype
    cache = hec.EmbeddingCache([6], 400, hec.ServeCacheConfig(
        cache_size=64, ways=4), device="cpu")
    cache.states[0] = ports[1]
    jcache = j_hec.EmbeddingCache([6], 400, j_hec.ServeCacheConfig(
        cache_size=64, ways=4))
    jcache.states[0] = refs[1]
    for a, b in zip(cache.cached_entries(0, sample, np.random.default_rng(1)),
                    jcache.cached_entries(0, sample,
                                          np.random.default_rng(1))):
        assert np.array_equal(a, b)


def test_staleness_publishes_as_reference():
    ports, refs, stacked = filled(2)
    reg, jreg = obs.MetricsRegistry(), jobs.MetricsRegistry()
    obs.QualityPlane(registry=reg).publish_staleness(
        [ports, ports[0]], layer_of=lambda i: i + 1)
    jobs.QualityPlane(registry=jreg).publish_staleness(
        [stacked, refs[0]], layer_of=lambda i: i + 1)
    assert reg.snapshot() == jreg.snapshot() and reg.snapshot()
    for l in (1, 2):
        a = reg.histogram(f"hec_stale_age_l{l}").samples
        b = jreg.histogram(f"hec_stale_age_l{l}").samples
        assert list(a) == list(b)


def test_hot_tier_reads_match_reference():
    never = hot_tier.NEVER
    assert never == int(j_hot._NEVER)
    hv = np.array([7, 11, 13, 17])
    age = np.array([[0, 2, never, 1], [1, never, 3, 0]], np.int32)
    vals = np.arange(2 * 4 * 8, dtype=np.float32).reshape(2, 4, 8)
    st = hot_tier.HotTierState(values=t(vals), age=t(age))
    js = SimpleNamespace(values=jnp.asarray(vals), age=jnp.asarray(age))
    for ls in (None, 1):
        for a, b in zip(hot_tier.tier_entries(st, hv, life_span=ls),
                        j_hot.tier_entries(js, hv, life_span=ls)):
            assert np.array_equal(a, b)
    assert hot_tier.replica_age_stats([st, st], 2) == \
        j_hot.replica_age_stats([js, js], 2)
    assert hot_tier.publish_replica_ages([st], 2) == \
        j_hot.publish_replica_ages([js], 2)
    assert obs.get().registry.snapshot() == jobs.get().registry.snapshot()
    assert list(obs.get().registry.histogram("hot_replica_age").samples) == \
        list(jobs.get().registry.histogram("hot_replica_age").samples)


def test_run_audit_and_convergence_match_reference(tmp_path):
    """The same sampled pairs: the same ``AuditReport`` and hidden-layer
    error, the same event log and gauges, and a budget breach routed to
    the health plane's ``FLIGHT_quality.json`` on both."""
    rng = np.random.default_rng(2)
    layers = []
    for l, (n, d) in enumerate([(20, 6), (15, 8), (0, 8)]):
        exact = rng.normal(size=(n, d)).astype(np.float32)
        cached = exact + rng.normal(size=(n, d)).astype(np.float32) * 0.3
        layers.append((l, cached, exact, rng.integers(0, 5, n)))
    hot = [(rng.normal(size=(4, 6)).astype(np.float32),
            rng.normal(size=(4, 6)).astype(np.float32)),
           (np.zeros((0, 8), np.float32), np.zeros((0, 8), np.float32))]
    out = []
    for mod, d in ((obs, "port"), (jobs, "ref")):
        reg = mod.MetricsRegistry()
        health = mod.HealthPlane(mod.HealthConfig(
            flight_dir=str(tmp_path / d), quality_budget=0.01,
            quality_window=1), registry=reg)
        q = mod.QualityPlane(mod.QualityConfig(audit_interval=2),
                             health=health, registry=reg)
        q.observe_epoch(0, {"loss": 1.5, "acc": 0.25, "grad_norm": 3.0,
                            "examples": 64.0, "other": 1.0})
        rep = q.run_audit(1, layers, hot_samples=hot, source="train")
        empty = q.run_audit(2, [(1, np.zeros((0, 3)), np.zeros((0, 3)),
                                 np.zeros(0))])
        out.append((rep, empty, reg, q, health))
        assert [q.should_audit(e) for e in range(4)] == \
            [False, True, False, True]
    (a, ea, reg, q, h), (b, eb, jreg, jq, jh) = out
    assert a.to_json() == b.to_json()
    assert a.hidden_mean_err() == b.hidden_mean_err()
    assert ea.mean_err is eb.mean_err is None
    assert reg.snapshot() == jreg.snapshot()
    assert list(reg.events_of("audit")) == list(jreg.events_of("audit"))
    assert list(reg.events_of("convergence")) == \
        list(jreg.events_of("convergence"))
    assert q.summary() == jq.summary()
    assert [d.to_json() for d in h.detections] == \
        [d.to_json() for d in jh.detections]
    assert (tmp_path / "port" / "FLIGHT_quality.json").exists()


# ---------------------------------------------------------------------------
# single-rank serving against the reference scheduler
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def sampled_parts():
    return graphs(num_vertices=600, avg_degree=6, num_classes=5,
                  feat_dim=16, seed=1)


@pytest.mark.parametrize("model", ["graphsage", "gat"])
def test_serving_audits_match_reference(sampled_parts, model):
    """A cold pass, then an audit (the same lines sampled, their ages
    equal, errors within 1e-5), then the caches emptied and the offline
    rows warmed in: an audit of exactly 0.0 on both."""
    part, jpart = sampled_parts
    cfg, jcfg = configs(2, model, fanouts=(3, 4))
    net, jparams = models(cfg, 0)
    kw = dict(num_slots=8, sample_seed=5)
    qa = obs.QualityPlane(obs.QualityConfig(audit_samples=40, seed=3))
    qb = jobs.QualityPlane(jobs.QualityConfig(audit_samples=40, seed=3))
    srv = GNNServeScheduler(cfg, net, part, GNNServeConfig(
        cache=ServeCacheConfig(cache_size=256, ways=4), **kw), device="cpu",
        quality=qa)
    jsrv = JScheduler(jcfg, jparams, jpart, JServeConfig(
        cache=JCacheConfig(cache_size=256, ways=4), **kw), quality=qb)
    vids = np.random.default_rng(0).integers(0, part.num_solid, 96)
    srv.serve(vids)
    jsrv.serve(vids)
    a, b = srv.audit(), jsrv.audit()
    assert a.epoch == b.epoch and a.source == b.source == "serve"
    for l in b.per_layer:
        x, y = a.per_layer[l], b.per_layer[l]
        assert x["n"] == y["n"] > 0 and x["age_mean"] == y["age_mean"]
        for k in ("err_mean", "err_p99", "err_max"):
            assert abs(x[k] - y[k]) <= 1e-5
    embs, jembs = (layerwise_embeddings(cfg, net, part),
                   j_layerwise(jcfg, jparams, jpart))
    srv.update_params(net)                     # drop the cold pass's lines
    jsrv.update_params(jparams)
    warm_cache(srv.cache, embs, np.arange(part.num_solid))
    j_warm(jsrv.cache, jembs, np.arange(jpart.num_solid))
    a, b = srv.audit(), jsrv.audit()
    assert a.mean_err == b.mean_err == 0.0
    assert all(v["err_max"] == 0.0 and v["n"] > 0
               for v in a.per_layer.values())


def test_serving_bit_identical_with_planes_on_or_off(sampled_parts, tmp_path):
    """Answers of two passes equal bit for bit with both planes on (an
    audit between the passes, an SLO target every round misses) or off;
    one health window a round, and the SLO burn dumps a flight file."""
    part, _ = sampled_parts
    cfg, _ = configs(2, "graphsage", fanouts=(3, 4))
    net, _ = models(cfg, 0)
    vids = np.random.default_rng(1).integers(0, part.num_solid, 200)
    outs = []
    for on in (False, True):
        kw = {}
        if on:
            health = obs.HealthPlane(obs.HealthConfig(
                flight_dir=str(tmp_path), slo_p99_s=1e-9, slo_min_samples=5),
                num_ranks=1)
            kw = dict(health=health, quality=obs.QualityPlane(health=health))
        srv = GNNServeScheduler(cfg, net, part, GNNServeConfig(
            num_slots=8, cache=ServeCacheConfig(cache_size=256, ways=4)),
            device="cpu", **kw)
        first = srv.serve(vids)
        if on:
            srv.audit()
        outs.append((first, srv.serve(vids), srv))
    (a1, a2, _), (b1, b2, srv) = outs
    assert np.array_equal(a1.view(np.int32), b1.view(np.int32))
    assert np.array_equal(a2.view(np.int32), b2.view(np.int32))
    assert srv.health.summary()["windows"] == srv.steps_run > 0
    dump = json.load(open(tmp_path / "FLIGHT_slo_burn.json"))
    assert dump["detection"]["detector"] == "slo_burn"


# ---------------------------------------------------------------------------
# sharded serving: the reference scheduler's own contract
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def shard_world():
    g = synthetic_graph(num_vertices=900, avg_degree=2, num_classes=5,
                        feat_dim=16, seed=3)
    ps = partition_graph(g, 4, seed=0)
    part = partition_graph(g, 1, seed=0).parts[0]
    max_deg = int((part.indptr[1:] - part.indptr[:-1]).max())
    out = {"ps": ps, "vids": np.arange(0, 900, 7)}
    for model in ("graphsage", "gat"):
        from repro_torch.configs.gnn import small_gnn_config
        cfg = small_gnn_config(model, batch_size=16, feat_dim=16,
                               num_classes=5, fanouts=(max_deg, max_deg),
                               hidden_size=32)
        net = build_model(cfg, seed=0, device="cpu", init="numpy")
        out[model] = (cfg, net, layerwise_embeddings_dist(cfg, net, ps,
                                                          chunk_size=128))
    return out


def shard_server(w, model, planes=None, **over):
    cfg, net, _ = w[model]
    scfg = DistServeConfig(num_slots=8, halo_slots=160,
                           cache=ServeCacheConfig(cache_size=8192, ways=4),
                           **over)
    return DistGNNServeScheduler(cfg, net, w["ps"], scfg, device="cpu",
                                 **(planes or {}))


@pytest.mark.parametrize("model", ["graphsage", "gat"])
def test_fresh_shards_audit_to_zero(shard_world, model):
    """Every shard warmed from the sharded offline pass, the hot replicas
    too: the audit samples every layer and the replicas, error exactly
    0.0, and publishes staleness and replica ages."""
    _, _, ed = shard_world[model]
    q = obs.QualityPlane(obs.QualityConfig(audit_samples=64))
    srv = shard_server(shard_world, model, dict(quality=q), hot_size=48)
    srv.cache.warm(ed, np.arange(900))
    assert srv.hot.warm(ed) > 0
    rep = srv.audit(epoch=0)
    assert rep.source == "serve_dist" and sorted(rep.per_layer) == [1, 2]
    assert all(v["n"] > 0 and v["err_max"] == 0.0
               for v in rep.per_layer.values())
    assert rep.hot["n"] > 0 and rep.hot["err_max"] == 0.0
    assert rep.mean_err == 0.0
    reg = obs.get().registry
    assert reg.value("hec_filled_frac_l1") > 0
    assert reg.value("hot_replica_filled_frac_l1") > 0


def test_sharded_planes_change_no_answer_and_series_sum(shard_world,
                                                         tmp_path):
    """The same stream through the hot tier, dedup and round batching
    with both planes (an audit between passes, an SLO every round
    misses) and without: bit-equal answers; the rank-labeled series,
    summed over the rounds and ranks, equal the scheduler's own halo and
    hot counters."""
    w = shard_world
    _, _, ed = w["graphsage"]
    vids = np.concatenate([np.repeat(w["vids"][:40], 2), w["vids"][40:]])
    outs = []
    for on in (False, True):
        planes = None
        if on:
            health = obs.HealthPlane(obs.HealthConfig(
                flight_dir=str(tmp_path), slo_p99_s=1e-9, slo_min_samples=5,
                slo_window=1), num_ranks=4,
                expected_halo_rows=[p.num_halo for p in w["ps"].parts])
            planes = dict(health=health, quality=obs.QualityPlane(
                health=health))
        obs.configure()
        srv = shard_server(w, "graphsage", planes, hot_size=48, dedup=True,
                           round_batch=2)
        srv.cache.warm(ed, np.arange(900), layers=range(1))
        first = srv.serve(vids)
        if on:
            srv.audit()
        outs.append((first, srv.serve(vids), srv, obs.get().registry))
    (a1, a2, _, _), (b1, b2, srv, reg) = outs
    assert np.array_equal(a1.view(np.int32), b1.view(np.int32))
    assert np.array_equal(a2.view(np.int32), b2.view(np.int32))
    m = srv.metrics()
    sums = {"rank_serve_halo_rows": m["halo_seen"],
            "rank_serve_halo_local": m["halo_local_hits"],
            "rank_serve_halo_fetched": m["halo_fetched"],
            "rank_serve_halo_requested": m["halo_requested"],
            "rank_serve_hot_hits": m["hot_hits"]}
    for name, want in sums.items():
        series = obs.rank_series(reg, name, 4)
        assert series is not None and series.sum() == want, name
    assert srv.health.summary()["windows"] == srv.steps_run > 0
    assert (tmp_path / "FLIGHT_slo_burn.json").exists()


def test_failover_still_raises(shard_world):
    with pytest.raises(NotImplementedError):
        shard_server(shard_world, "graphsage", failover=True)


# ---------------------------------------------------------------------------
# the launchers' plane flags
# ---------------------------------------------------------------------------
def test_serve_launchers_plane_flags(tmp_path, capsys):
    """``gnn_serve`` audits each pass (the warm one to exactly 0.0) and an
    SLO every round misses dumps ``FLIGHT_slo_burn.json``; so does
    ``gnn_serve_dist``, whose audits run after both passes."""
    from repro_torch.launch import gnn_serve, gnn_serve_dist
    flags = ["--device", "cpu", "--vertices", "2000", "--queries", "256",
             "--audit-interval", "1", "--slo-p99-ms", "0.000001",
             "--flight-dir"]
    out = gnn_serve.run(gnn_serve.parse_args(flags + [str(tmp_path / "a")]))
    assert [r.mean_err == 0.0 for r in out["audits"]] == [False, True]
    assert json.load(open(tmp_path / "a" / "FLIGHT_slo_burn.json"))
    out = gnn_serve_dist.run(gnn_serve_dist.parse_args(
        flags + [str(tmp_path / "b"), "--round-batch", "1"]))
    assert len(out["audits"]) == 2
    assert json.load(open(tmp_path / "b" / "FLIGHT_slo_burn.json"))
    assert "audit:" in capsys.readouterr().out


def test_train_launcher_plane_flags(tmp_path):
    from repro_torch.launch import train
    res = train.run_gnn(train.parse_args([
        "gnn", "--device", "cpu", "--ranks", "2", "--vertices", "1200",
        "--epochs", "3", "--audit-interval", "1", "--quality-budget", "1e-9",
        "--flight-dir", str(tmp_path)]))
    # two audits over budget in a row (the first epoch's HEC is empty)
    assert res["quality"].audits_run == 3
    assert res["health"].summary()["windows"] == 3
    assert (tmp_path / "FLIGHT_quality.json").exists()
