"""The port's serving path (GraphSAGE and GAT) against the reference's,
on the CPU.

The same numpy weights (``init_params_np``) go into the reference's
``{"layers": [...]}`` tree and, through ``params_from_jax``, into the
port's ``GraphSAGE`` or ``GAT``; the same graph and workload go through
both schedulers.  Floats within atol=rtol=1e-5 (torch and XLA sum float32 in
different orders); counters and cache tags exactly.  Also: the port's own
serving contracts (cached == uncached, invalidation, exactness, admission),
its device rule, and that it never imports ``jax`` or ``repro``.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.gnn import small_gnn_config as j_small_config
from repro.graph import partition_graph as j_partition_graph
from repro.graph import synthetic_graph as j_synthetic_graph
from repro.models.gnn import graphsage as j_sage
from repro.serve.gnn import GNNServeConfig as JServeConfig
from repro.serve.gnn import GNNServeScheduler as JScheduler
from repro.serve.gnn import ServeCacheConfig as JCacheConfig
from repro.serve.gnn import direct_forward as j_direct_forward
from repro.serve.gnn import layerwise_embeddings as j_layerwise
from repro_torch.configs.gnn import small_gnn_config
from repro_torch.device import resolve_device
from repro_torch.graph import partition_graph, synthetic_graph
from repro_torch.models.gnn import gat as gat_lib
from repro_torch.models.gnn.graphsage import (GraphSAGE, init_params_np,
                                              layer_dims)
from repro_torch.pipeline.vectorized_sampler import sample_blocks_vectorized
from repro_torch.serve.gnn import (AdmissionRejected, GNNServeConfig,
                                   GNNServeScheduler, ServeCacheConfig,
                                   direct_forward, layerwise_embeddings,
                                   serve_layer_dims, warm_cache)

TOL = dict(atol=1e-5, rtol=1e-5)
CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]


def graphs(**kw):
    return (partition_graph(synthetic_graph(**kw), 1).parts[0],
            j_partition_graph(j_synthetic_graph(**kw), 1).parts[0])


@pytest.fixture(scope="module")
def exact_parts():
    """Every degree <= fanout: sampling keeps all neighbors, so minibatch
    inference is exact (as in tests/test_gnn_serving.py)."""
    return graphs(num_vertices=700, avg_degree=2, num_classes=5,
                  feat_dim=16, seed=3)


@pytest.fixture(scope="module")
def sampled_parts():
    return graphs(num_vertices=600, avg_degree=6, num_classes=5,
                  feat_dim=16, seed=1)


def configs(layers=2, model="graphsage", **over):
    kw = dict(batch_size=16, feat_dim=16, num_classes=5, hidden_size=32,
              num_hidden_layers=layers - 1, **over)
    if model == "gat":
        kw.update(hidden_size=8, num_heads=3)
    return small_gnn_config(model, **kw), j_small_config(model, **kw)


def models(cfg, seed):
    """The same numpy weights as a port model and a reference tree."""
    if cfg.model == "gat":
        shapes = gat_lib.layer_shapes(cfg.feat_dim, cfg.hidden_size,
                                      cfg.num_classes, cfg.num_layers,
                                      cfg.num_heads)
        p = gat_lib.init_params_np(seed, shapes)
        model = gat_lib.GAT(shapes).params_from_jax(p)
    else:
        dims = layer_dims(cfg.feat_dim, cfg.hidden_size, cfg.num_classes,
                          cfg.num_layers)
        p = init_params_np(seed, dims)
        model = GraphSAGE(dims).params_from_jax(p)
    return model, jax.tree_util.tree_map(jnp.asarray, p)


def exact_cfgs(part, layers=2, model="graphsage"):
    d = int((part.indptr[1:] - part.indptr[:-1]).max())
    return configs(layers, model, fanouts=(d,) * layers)


# ---------------------------------------------------------------------------
# model and offline engine
# ---------------------------------------------------------------------------
def test_init_params_np_he_normal_and_loads():
    dims = [64, 128, 128, 10]
    p = init_params_np(0, dims)
    for l, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        layer = p["layers"][l]
        assert layer["wn"].shape == layer["ws"].shape == (din, dout)
        assert layer["wn"].dtype == np.float32
        assert np.std(layer["wn"]) == pytest.approx((2 / din) ** 0.5,
                                                    rel=0.1)
        assert not layer["b"].any()
    m = GraphSAGE(dims).params_from_jax(p)
    np.testing.assert_array_equal(m.layers[1].ws.detach().numpy(),
                                  p["layers"][1]["ws"])
    assert all(q.requires_grad for q in m.parameters())   # trainable
    with pytest.raises(ValueError):
        GraphSAGE(dims[:-1]).params_from_jax(p)


@pytest.mark.parametrize("layers", [2, 3])
def test_graphsage_forward_matches_reference(sampled_parts, layers):
    """Forward with a substituting halo hook, on sampled blocks."""
    part, _ = sampled_parts
    cfg, _ = configs(layers, fanouts=(3, 4, 5)[:layers])
    model, jparams = models(cfg, seed=layers)
    blocks = sample_blocks_vectorized(part, np.arange(0, 40, 3),
                                      cfg.fanouts, np.random.default_rng(0),
                                      16)
    h0 = part.features[np.maximum(blocks.layer_nodes[0], 0)] \
        * blocks.node_mask[0][:, None]
    rng = np.random.default_rng(1)
    subst = {k: (rng.random(len(blocks.layer_nodes[k])) < 0.3,
                 rng.normal(size=(len(blocks.layer_nodes[k]),
                                  cfg.hidden_size)).astype(np.float32))
             for k in range(1, layers)}

    def hook_for(lib, asarray):
        def hook(k, h, valid):
            if k == 0:
                return h, valid
            hit, emb = (asarray(x) for x in subst[k])
            return lib.where(hit[:, None], emb, h), valid | hit
        return hook

    out, valid = model(torch.as_tensor(h0), torch.as_tensor(blocks.node_mask[0]),
                       {"nbr_idx": [torch.as_tensor(x, dtype=torch.int32)
                                    for x in blocks.nbr_idx]},
                       halo_hook=hook_for(torch, torch.as_tensor))
    jout, jvalid = j_sage.forward(
        jparams, jnp.asarray(h0), jnp.asarray(blocks.node_mask[0]),
        {"nbr_idx": [jnp.asarray(x, jnp.int32) for x in blocks.nbr_idx]},
        halo_hook=hook_for(jnp, jnp.asarray))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))


@pytest.mark.parametrize("model,layers", [
    ("graphsage", 2), ("graphsage", 3), ("gat", 2), ("gat", 3)],
    ids=["2", "3", "gat-2", "gat-3"])
def test_layerwise_embeddings_match_reference(exact_parts, model, layers):
    part, jpart = exact_parts
    cfg, jcfg = exact_cfgs(part, layers, model)
    model, jparams = models(cfg, seed=0)
    embs = layerwise_embeddings(cfg, model, part, chunk_size=128)
    jembs = j_layerwise(jcfg, jparams, jpart, chunk_size=128)
    assert [e.shape[1] for e in embs] == serve_layer_dims(cfg)
    for e, je in zip(embs, jembs):
        np.testing.assert_allclose(e.numpy(), np.asarray(je), **TOL)
    direct = direct_forward(cfg, model, part).numpy()
    np.testing.assert_allclose(direct, np.asarray(
        j_direct_forward(jcfg, jparams, jpart)), **TOL)
    np.testing.assert_allclose(embs[-1].numpy(), direct, **TOL)


# ---------------------------------------------------------------------------
# the scheduler against the reference scheduler
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model,layers,dedup", [
    ("graphsage", 2, False), ("graphsage", 3, True), ("gat", 2, False),
    ("gat", 3, True)], ids=["2-False", "3-True", "gat-2-False", "gat-3-True"])
def test_scheduler_matches_reference(sampled_parts, model, layers, dedup):
    """Random sampling, a small cache with evictions, repeats: answers
    within tolerance; steps, fast-path hits, per-layer hits/lookups and
    the final cache tags identical."""
    part, jpart = sampled_parts
    cfg, jcfg = configs(layers, model, fanouts=(3, 4, 5)[:layers])
    model, jparams = models(cfg, seed=7)
    rng = np.random.default_rng(3)
    vids = np.concatenate([rng.integers(0, part.num_solid, 60),
                           rng.integers(0, 40, 40)])
    kw = dict(num_slots=8, sample_seed=5, dedup=dedup)
    srv = GNNServeScheduler(cfg, model, part, GNNServeConfig(
        cache=ServeCacheConfig(cache_size=256, ways=4), **kw), device="cpu")
    jsrv = JScheduler(jcfg, jparams, jpart, JServeConfig(
        cache=JCacheConfig(cache_size=256, ways=4), **kw))
    for wave in (vids, vids[::-1]):
        out, jout = srv.serve(wave), jsrv.serve(wave)
        np.testing.assert_allclose(out, jout, **TOL)
    m, jm = srv.metrics(), jsrv.metrics()
    keys = ["steps_run", "fast_path_hits", "dedup_merged", "queries_served"]
    keys += [f"{s}_l{k}" for s in ("hits", "lookups")
             for k in range(1, layers + 1)]
    assert {k: m[k] for k in keys} == {k: jm[k] for k in keys}
    assert m["fast_path_hits"] > 0 and m["hits_l1"] > 0
    for ts, js in zip(srv.cache.states, jsrv.cache.states):
        np.testing.assert_array_equal(ts.tags.numpy(), np.asarray(js.tags))


# ---------------------------------------------------------------------------
# the port's own serving contracts
# ---------------------------------------------------------------------------
def make_server(cfg, model, part, enabled=True, slots=8, **kw):
    cache = ServeCacheConfig(cache_size=8192, ways=4, enabled=enabled)
    return GNNServeScheduler(cfg, model, part,
                             GNNServeConfig(num_slots=slots, cache=cache,
                                            **kw), device="cpu")


def test_cached_equals_uncached(exact_parts):
    part, _ = exact_parts
    cfg, _ = exact_cfgs(part)
    model, _ = models(cfg, seed=0)
    rng = np.random.default_rng(0)
    vids = np.concatenate([rng.integers(0, part.num_solid, 48),
                           rng.integers(0, part.num_solid, 48)])
    cached = make_server(cfg, model, part)
    uncached = make_server(cfg, model, part, enabled=False)
    out_c, out_u = cached.serve(vids), uncached.serve(vids)
    np.testing.assert_allclose(out_c, out_u, **TOL)
    m, mu = cached.metrics(), uncached.metrics()
    assert m["fast_path_hits"] + m[f"hits_l{cfg.num_layers}"] > 0
    assert mu["fast_path_hits"] == 0
    assert all(mu[f"hits_l{k}"] == 0 for k in range(1, cfg.num_layers + 1))
    steps = cached.steps_run
    np.testing.assert_array_equal(cached.serve(vids), out_c)
    assert cached.steps_run == steps          # all resident: no microbatch


def test_update_params_invalidates_cache(exact_parts):
    part, _ = exact_parts
    cfg, _ = exact_cfgs(part)
    m1, _ = models(cfg, seed=0)
    m2, _ = models(cfg, seed=9)
    vids = np.arange(24)
    srv = make_server(cfg, m1, part)
    out_old = srv.serve(vids)
    assert srv.update_params(m2) == 1
    assert srv.metrics()["occupancy_l1"] == 0.0
    assert not any(r.any() for r in srv.cache.resident)
    out_new = srv.serve(vids)
    np.testing.assert_allclose(out_new, make_server(cfg, m2, part).serve(vids),
                               **TOL)
    assert not np.allclose(out_new, out_old, atol=1e-3)
    req = srv.submit(0)
    srv.pump()
    assert req.model_version == 1 and req.served_by == "output_cache"


def test_serving_exact_and_warm_fast_path(exact_parts):
    part, _ = exact_parts
    cfg, _ = exact_cfgs(part, layers=3)
    model, _ = models(cfg, seed=1)
    vids = np.arange(0, part.num_solid, 7)
    embs = layerwise_embeddings(cfg, model, part, chunk_size=128)
    out = make_server(cfg, model, part).serve(vids)
    np.testing.assert_allclose(out, embs[-1].numpy()[vids], **TOL)
    warm = make_server(cfg, model, part)
    warm_cache(warm.cache, embs, np.arange(part.num_solid))
    out_w = warm.serve(vids)
    assert warm.steps_run == 0
    assert warm.metrics()["fast_path_hits"] == len(vids)
    np.testing.assert_array_equal(out_w, embs[-1].numpy()[vids])


def test_admission_dedup_and_latency(exact_parts):
    part, _ = exact_parts
    cfg, _ = exact_cfgs(part)
    model, _ = models(cfg, seed=0)
    srv = make_server(cfg, model, part, max_queue_depth=4)
    reqs = [srv.submit(v) for v in range(4)]
    with pytest.raises(AdmissionRejected):
        srv.submit(99)
    srv.pump()
    assert all(r.done and r.served_by == "compute" for r in reqs)
    srv.serve([0, 1])                      # fast-path answers
    m = srv.metrics()
    assert m["queries_rejected"] == 1 and m["queries_served"] == 6
    assert m["latency_count"] == 6
    assert m["latency_p99_ms"] >= m["latency_p50_ms"] > 0.0
    ddup = make_server(cfg, model, part, enabled=False, dedup=True)
    plain = make_server(cfg, model, part, enabled=False)
    twice = np.repeat(np.arange(10, 22), 2)
    np.testing.assert_array_equal(ddup.serve(twice), plain.serve(twice))
    assert ddup.dedup_merged > 0 and ddup.steps_run < plain.steps_run


def test_offline_refuses_a_model_of_another_kind(exact_parts):
    part, _ = exact_parts
    cfg, _ = exact_cfgs(part, model="gat")
    sage, _ = models(exact_cfgs(part)[0], seed=0)
    with pytest.raises(ValueError, match="does not serve"):
        layerwise_embeddings(cfg, sage, part)


def test_gat_serving_exact_and_warm_fast_path(exact_parts):
    """GAT: sampled serving on an exact-sampling graph equals the offline
    embeddings; a warmed server answers from them bit for bit."""
    part, _ = exact_parts
    cfg, _ = exact_cfgs(part, layers=3, model="gat")
    model, _ = models(cfg, seed=1)
    vids = np.arange(0, part.num_solid, 7)
    embs = layerwise_embeddings(cfg, model, part, chunk_size=128)
    assert [e.shape[1] for e in embs] == [24, 24, 5]
    out = make_server(cfg, model, part).serve(vids)
    np.testing.assert_allclose(out, embs[-1].numpy()[vids], **TOL)
    np.testing.assert_allclose(direct_forward(cfg, model, part).numpy(),
                               embs[-1].numpy(), **TOL)
    warm = make_server(cfg, model, part)
    warm_cache(warm.cache, embs, np.arange(part.num_solid))
    out_w = warm.serve(vids)
    assert warm.steps_run == 0
    np.testing.assert_array_equal(out_w, embs[-1].numpy()[vids])


def test_device_none_means_cuda_and_never_falls_back(exact_parts,
                                                     monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu") == CPU
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    part, _ = exact_parts
    cfg, _ = exact_cfgs(part)
    model, _ = models(cfg, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GNNServeScheduler(cfg, model, part)


def test_launcher_flow_on_cpu(tmp_path):
    from repro_torch.launch import gnn_serve
    from repro_torch.configs.gnn import GRAPHSAGE_PAPERS100M
    from repro_torch.obs import validate_chrome_trace
    cfg = gnn_serve.model_config("graphsage-papers100m")
    assert cfg is GRAPHSAGE_PAPERS100M
    assert (cfg.feat_dim, cfg.hidden_size, cfg.num_layers, cfg.num_classes,
            tuple(cfg.fanouts)) == (128, 256, 3, 172, (5, 10, 15))
    trace = tmp_path / "trace.json"
    res = gnn_serve.run(gnn_serve.parse_args(
        ["--device", "cpu", "--vertices", "800", "--queries", "96",
         "--slots", "8", "--trace-out", str(trace)]))
    assert res["device_trace"] == {}          # no card here: not measured
    assert validate_chrome_trace(json.loads(trace.read_text())) > 0
    assert res["cold_ms_per_microbatch"]["serve_sample"] > 0
    assert all(np.isfinite(r.result).all() for r in res["cold"] + res["warm"])
    offline = res["embs"][-1].numpy()
    fast = [r for r in res["warm"] if r.served_by == "output_cache"]
    assert fast and all(np.array_equal(r.result, offline[r.vid])
                        for r in fast)


def test_gat_launcher_flow_on_cpu(capsys):
    from repro_torch.configs.gnn import GAT_PAPERS100M
    from repro_torch.launch import gnn_serve
    cfg = gnn_serve.model_config("gat-papers100m")
    assert cfg is GAT_PAPERS100M
    assert gnn_serve.model_config("gat-papers100m", "gat") is cfg
    assert (cfg.model, cfg.feat_dim, cfg.hidden_size, cfg.num_heads,
            cfg.num_layers, cfg.num_classes, tuple(cfg.fanouts), cfg.lr) == \
        ("gat", 128, 256, 4, 3, 172, (5, 10, 15), 0.001)
    with pytest.raises(SystemExit):
        gnn_serve.model_config("gat-papers100m", "graphsage")
    res = gnn_serve.run(gnn_serve.parse_args(
        ["--model", "gat", "--device", "cpu", "--vertices", "800",
         "--queries", "96", "--slots", "8"]))
    assert "model gat-small (32->256x1->16, 4 heads" in capsys.readouterr().out
    assert res["cfg"].model == "gat"
    assert all(np.isfinite(r.result).all() for r in res["cold"] + res["warm"])
    offline = res["embs"][-1].numpy()
    fast = [r for r in res["warm"] if r.served_by == "output_cache"]
    assert fast and all(np.array_equal(r.result, offline[r.vid])
                        for r in fast)


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------
def imported_modules(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


def test_port_never_imports_jax_or_repro_ast():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    names = {str(f.relative_to(REPO / "src")) for f in files[:-1]}
    assert {f"repro_torch/{m}.py" for m in (
        "cache/hot_tier", "comm/engine", "comm/plan",
        "pipeline/vectorized_sampler", "launch/gnn_serve_dist",
        "serve/gnn/distributed/__init__", "serve/gnn/distributed/router",
        "serve/gnn/distributed/sharded_cache",
        "serve/gnn/distributed/offline",
        "serve/gnn/distributed/scheduler")} <= names
    bad = {str(f.relative_to(REPO)): m for f in files
           for m in imported_modules(f) if forbidden(m)}
    assert not bad


def test_port_never_imports_jax_or_repro_at_runtime():
    mods = sorted(
        ".".join(p.relative_to(REPO / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in (REPO / "src" / "repro_torch").rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\nprint(len(" + repr(mods) + "))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) == len(mods)
