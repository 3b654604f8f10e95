"""The port's sharded serving slice against the reference, on the CPU.

The same numpy inputs go through ``repro`` and ``repro_torch``:
- kernel J's plain version ``hec_probe_ref`` against the reference's
  ``hec_probe`` (Pallas in interpret mode) and its response packing,
  bit for bit;
- the host pieces (``route``, ``hot_set_tables``, the offline halo
  exchange, ``concat_blocks``, the hot tier's ops, the stacked cache's
  ``warm``), bit for bit;
- the whole scheduler against the reference's ``DistGNNServeScheduler``,
  run once in a subprocess with four forced host devices on the
  900-vertex graph of ``tests/test_dist_serving.py``, where every degree
  is at most the fanout: answers within atol=rtol=1e-5 (torch and XLA sum
  float32 in different orders), every counter and occupancy exactly, and
  ``cache_fetch`` alone (budgets overrun, fused rounds, a dead rank) bit
  for bit.

Where the reference stops here (dedup, a warmed hot tier, output-cache
hits after a compute round: ``ValueError: Mapped away dimension ...`` in
its fast-path ``vmap``), the port is held to the reference test's own
contract: bit-equal answers to its features-off and single-rank
schedulers.  The round-batching anomaly (one of 169 answers inexact with
``round_batch=2`` on a stream of adjacent repeats) is the reference's
behaviour, and the port reproduces it (ROADMAP.md section 3).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import hec as j_hec
from repro.cache import hot_tier as j_hot
from repro.comm.engine import HaloExchangeEngine as JEngine
from repro.comm.plan import hot_set_tables as j_hot_set_tables
from repro.graph import partition_graph as j_partition_graph
from repro.graph import synthetic_graph as j_synthetic_graph
from repro.graph.sampling import MinibatchBlocks as JBlocks
from repro.kernels.hec_search import hec_probe as j_hec_probe
from repro.pipeline.vectorized_sampler import concat_blocks as j_concat
from repro_torch.cache import hec, hot_tier
from repro_torch.cache.hec import EmbeddingCache, ServeCacheConfig
from repro_torch.comm import HaloExchangeEngine
from repro_torch.comm.plan import hot_set_tables
from repro_torch.configs.gnn import small_gnn_config
from repro_torch.graph import partition_graph, synthetic_graph
from repro_torch.kernels import hec_search as hs
from repro_torch.kernels.ref import hec_probe_ref
from repro_torch.models.gnn import build_model
from repro_torch.pipeline.vectorized_sampler import (concat_blocks,
                                                     sample_blocks_vectorized)
from repro_torch.serve.gnn import (GNNServeConfig, GNNServeScheduler,
                                   layerwise_embeddings, prewarm, warm_cache)
from repro_torch.serve.gnn.distributed import (DistGNNServeScheduler,
                                               DistServeConfig, QueryRouter,
                                               exchange_halos,
                                               layerwise_embeddings_dist)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TOL = dict(atol=1e-5, rtol=1e-5)
R = 4


def bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


# ---------------------------------------------------------------------------
# kernel J's plain version against the reference's batched probe
# ---------------------------------------------------------------------------
def j_state(rng, nsets, ways, d, stored):
    """A reference cache holding ``stored`` (full sets included)."""
    st = j_hec.hec_init(nsets * ways, ways, d)
    for s in range(0, len(stored), 64):
        v = stored[s:s + 64]
        st = j_hec.hec_store(st, jnp.asarray(v, jnp.int32), jnp.asarray(
            rng.standard_normal((len(v), d)).astype(np.float32)))
    return st


@pytest.mark.parametrize("d,n", [(6, 37), (13, 5), (8, 64)])
def test_hec_probe_ref_matches_reference_probe(d, n):
    """Hits and values bit for bit against ``hec_probe(interpret=True)``:
    negative vids, full sets (more stores than ways), misses, ragged n and
    d off a multiple of 4."""
    rng = np.random.default_rng(d * 100 + n)
    nsets, ways, B = 16, 4, 3
    sets = np.asarray(j_hec.set_index(jnp.arange(400, dtype=jnp.int32),
                                      nsets))
    full = np.flatnonzero(sets == 3)[:ways + 3]          # overfill set 3
    stored = np.unique(np.concatenate([rng.choice(400, 30, replace=False),
                                       full]))
    st = j_state(rng, nsets, ways, d, stored)
    vids = rng.integers(-5, 420, (B, n)).astype(np.int32)
    vids[0, :min(n, len(full))] = full[:n]
    hit, emb = j_hec_probe(st, jnp.asarray(vids), interpret=True)
    tags = torch.tensor(np.asarray(st.tags))[None]
    values = torch.tensor(np.asarray(st.values))[None]
    packed = hec_probe_ref(tags, values, torch.as_tensor(vids)[None])
    assert packed.shape == (1, B, n, d + 1)
    np.testing.assert_array_equal(packed[0, ..., d].numpy() > 0.5,
                                  np.asarray(hit))
    np.testing.assert_array_equal(bits(packed[0, ..., :d].numpy()),
                                  bits(np.asarray(emb)))
    assert np.asarray(hit).any() and not np.asarray(hit).all()
    # on CPU tensors the wrapper runs the plain version
    before = hs.hec_probe.launches
    np.testing.assert_array_equal(
        bits(hs.hec_probe(tags, values,
                          torch.as_tensor(vids)[None]).numpy()),
        bits(packed.numpy()))
    assert hs.hec_probe.launches == before


def test_hec_probe_ref_packing_and_alive_match_reference_concatenate():
    """The response buffer of R stacked responders equals the reference's
    ``concatenate([vals, own & alive[me]])`` per responder, bit for bit; a
    dead responder keeps its values and answers ok=0."""
    rng = np.random.default_rng(11)
    d, nsets, ways, B, n = 5, 8, 4, 4, 9
    states = [j_state(rng, nsets, ways, d, rng.choice(200, 25, False))
              for _ in range(R)]
    vids = rng.integers(-2, 200, (R, B, n)).astype(np.int32)
    alive = np.array([True, False, True, True])
    want = []
    for r, st in enumerate(states):
        own, vals = j_hec.hec_lookup(st, jnp.asarray(vids[r].reshape(-1)))
        own = own & alive[r]
        want.append(np.asarray(jnp.concatenate(
            [vals.astype(jnp.float32), own[:, None].astype(jnp.float32)],
            -1)).reshape(B, n, d + 1))
    tags = torch.as_tensor(np.stack([np.asarray(s.tags) for s in states]))
    values = torch.as_tensor(np.stack([np.asarray(s.values)
                                       for s in states]))
    got = hec_probe_ref(tags, values, torch.as_tensor(vids),
                        torch.as_tensor(alive))
    np.testing.assert_array_equal(bits(got.numpy()), bits(np.stack(want)))
    assert got[1, ..., d].sum() == 0 and got[1, ..., :d].abs().sum() > 0
    all_alive = hec_probe_ref(tags, values, torch.as_tensor(vids))
    np.testing.assert_array_equal(
        bits(all_alive.numpy()),
        bits(hec_probe_ref(tags, values, torch.as_tensor(vids),
                           torch.ones(R, dtype=torch.bool)).numpy()))


# ---------------------------------------------------------------------------
# host pieces, bit for bit
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def parts():
    kw = dict(num_vertices=600, avg_degree=5, num_classes=4, feat_dim=8,
              seed=1)
    return (partition_graph(synthetic_graph(**kw), R, seed=0),
            j_partition_graph(j_synthetic_graph(**kw), R, seed=0))


def test_route_and_hot_set_tables_match_reference(parts):
    ps, jps = parts
    vids = np.random.default_rng(0).integers(0, 600, 300)
    for a, b in zip(ps.route(vids), jps.route(vids)):
        np.testing.assert_array_equal(a, b)
    for bad in ([-1, 3], [600]):
        with pytest.raises(ValueError, match="out of range"):
            ps.route(np.array(bad))
        with pytest.raises(ValueError, match="out of range"):
            jps.route(np.array(bad))
    for k in (0, 1, 7, 50, 10 ** 6):
        for a, b in zip(hot_set_tables(ps, k), j_hot_set_tables(jps, k)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    # routing packs each query's owner-local VID_p onto its owner's queue
    router = QueryRouter(ps)
    req = type("Q", (), {"vid": int(vids[0])})()
    r = router.enqueue(req)
    assert r == ps.owner[vids[0]]
    assert router.drain(r, 5) == [(req, int(ps.local_index[vids[0]]))]


def test_exchange_halos_host_matches_reference(parts):
    ps, jps = parts
    rng = np.random.default_rng(3)
    h = [rng.standard_normal((p.num_solid, 7)).astype(np.float32)
         for p in ps.parts]
    want, want_bytes = JEngine.from_partition(jps).exchange_halos_host(h)
    got, nbytes = exchange_halos(ps, [torch.as_tensor(x) for x in h])
    assert nbytes == want_bytes > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(bits(g.numpy()), bits(w))


def test_concat_blocks_matches_reference(parts):
    """Segments of unequal fill (full, partial, empty), fused by both."""
    ps, _ = parts
    part = ps.parts[1]
    rng = np.random.default_rng(4)
    segs = []
    for n, fill in enumerate((8, 3, 0, 5)):
        seeds = rng.choice(part.num_solid, fill, replace=False)
        segs.append(sample_blocks_vectorized(
            part, seeds, (3, 4), np.random.default_rng([1, n]), 8))
    got = concat_blocks(segs)
    want = j_concat([JBlocks(**dataclasses.asdict(s)) for s in segs])
    for f in ("layer_nodes", "node_mask", "nbr_idx"):
        for a, b in zip(getattr(got, f), getattr(want, f)):
            np.testing.assert_array_equal(a, b)
    for f in ("seeds", "seed_mask", "labels"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert concat_blocks(segs[:1]) is segs[0]


def test_hot_tier_ops_match_reference():
    """``tier_slots``, ``tier_lookup`` and ``tier_store`` with duplicate and
    -1 slots choose the reference's winner (the last valid row); ages and
    ``tier_tick`` saturate at NEVER as the reference's do."""
    rng = np.random.default_rng(6)
    K, d = 9, 5
    hot = np.sort(rng.choice(100, K, replace=False)).astype(np.int32)
    vids = np.concatenate([hot[[0, 3, 3, 8]], [-1, 101, 2, hot[5]]]) \
        .astype(np.int32)
    js, jh = j_hot.tier_slots(jnp.asarray(hot), jnp.asarray(vids))
    ts, th = hot_tier.tier_slots(torch.as_tensor(hot, dtype=torch.int64),
                                 torch.as_tensor(vids))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    slots = np.array([2, 5, 2, -1, 7, 5, 5, 0, -1, 2], np.int32)
    embs = rng.standard_normal((len(slots), d)).astype(np.float32)
    jst = j_hot.tier_store(j_hot.tier_init(K, d), jnp.asarray(slots),
                           jnp.asarray(embs))
    jst = j_hot.tier_tick(jst)
    tst = hot_tier.tier_init(K, d, CPU)
    hot_tier.tier_store(tst, torch.as_tensor(slots), torch.as_tensor(embs))
    hot_tier.tier_tick(tst)
    np.testing.assert_array_equal(bits(tst.values.numpy()),
                                  bits(np.asarray(jst.values)))
    np.testing.assert_array_equal(tst.age.numpy(), np.asarray(jst.age))
    for life in (None, 0, 1):
        jhit, jemb = j_hot.tier_lookup(jst, jnp.asarray(hot),
                                       jnp.asarray(vids), life)
        thit, temb = hot_tier.tier_lookup(
            tst, torch.as_tensor(hot, dtype=torch.int64),
            torch.as_tensor(vids), life)
        np.testing.assert_array_equal(thit.numpy(), np.asarray(jhit))
        np.testing.assert_array_equal(bits(temb.numpy()),
                                      bits(np.asarray(jemb)))
    for a, b in zip(hot_tier.tier_entries(tst, hot),
                    j_hot.tier_entries(jst, hot)):
        np.testing.assert_array_equal(bits(a), bits(b))


def test_stacked_cache_warm_matches_reference(parts):
    """``EmbeddingCache(ps=...)``: owner-routed ``warm`` (chunks smaller
    than a shard, a layer subset) gives the reference's tags on every
    shard, and the residency mirrors and leaf masks follow."""
    ps, jps = parts
    rng = np.random.default_rng(8)
    dims = [6, 3]
    embs = [rng.standard_normal((600, dk)).astype(np.float32) for dk in dims]
    vids = rng.choice(600, 350, replace=False)
    cfg = ServeCacheConfig(cache_size=128, ways=4)
    got = EmbeddingCache(dims, 600, cfg, ps=ps, device="cpu")
    want = j_hec.EmbeddingCache(dims, 600, j_hec.ServeCacheConfig(
        cache_size=128, ways=4), ps=jps)
    got.warm([torch.as_tensor(e) for e in embs], vids, chunk=40, layers=[1])
    want.warm(embs, vids, chunk=40, layers=[1])
    for k in range(2):
        np.testing.assert_array_equal(got.states[k].tags.numpy(),
                                      np.asarray(want.states[k].tags))
        np.testing.assert_array_equal(bits(got.states[k].values.numpy()),
                                      bits(np.asarray(want.states[k].values)))
        np.testing.assert_array_equal(got.resident[k], want.resident[k])
    for r in range(R):
        for a, b in zip(got.expandable_masks(r)[1:],
                        want.expandable_masks(r)[1:]):
            np.testing.assert_array_equal(a, b)
    assert got.occupancy() == pytest.approx(want.occupancy(), abs=0)
    with pytest.raises(ValueError, match="shard rank"):
        got.expandable_masks()
    assert got.on_model_update() == 1 and max(got.occupancy()) == 0.0


# ---------------------------------------------------------------------------
# the scheduler against the reference's, on the test_dist_serving graph
# ---------------------------------------------------------------------------
_REF_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import json
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from repro.cache import hec as hec_lib
from repro.comm.engine import HaloExchangeEngine
from repro.configs.gnn import small_gnn_config
from repro.graph import partition_graph, synthetic_graph
from repro.launch.mesh import make_gnn_mesh
from repro.serve.gnn import ServeCacheConfig
from repro.serve.gnn.distributed import (DistGNNServeScheduler,
                                         DistServeConfig,
                                         layerwise_embeddings_dist)
from repro.utils import compat
from repro_torch.models.gnn import gat as t_gat
from repro_torch.models.gnn import graphsage as t_sage

R = 4
g = synthetic_graph(num_vertices=900, avg_degree=2, num_classes=5,
                    feat_dim=16, seed=3)
part = partition_graph(g, 1, seed=0).parts[0]
ps = partition_graph(g, R, seed=0)
max_deg = int((part.indptr[1:] - part.indptr[:-1]).max())
mesh = make_gnn_mesh(R)
out = {}


def make(model):
    cfg = small_gnn_config(model, batch_size=16, feat_dim=16, num_classes=5,
                           fanouts=(max_deg, max_deg), hidden_size=32)
    if model == "gat":
        p = t_gat.init_params_np(0, t_gat.layer_shapes(
            cfg.feat_dim, cfg.hidden_size, cfg.num_classes, cfg.num_layers,
            cfg.num_heads))
    else:
        p = t_sage.init_params_np(0, t_sage.layer_dims(
            cfg.feat_dim, cfg.hidden_size, cfg.num_classes, cfg.num_layers))
    return cfg, jax.tree_util.tree_map(jnp.asarray, p)


KEYS = ("steps_run", "fast_path_hits", "halo_seen", "halo_fetched",
        "halo_local_hits", "halo_requested", "hits_l1", "hits_l2",
        "lookups_l1", "lookups_l2", "occupancy_l1", "occupancy_l2")
all_v = np.arange(g.num_vertices)
vids = np.arange(0, g.num_vertices, 7)
vids_rep = np.concatenate([np.repeat(vids[:40], 2), vids[40:]])
embs = {}
for model in ("graphsage", "gat"):
    cfg, params = make(model)
    ed, st = layerwise_embeddings_dist(cfg, params, ps, chunk_size=128,
                                       with_stats=True)
    embs[model] = (cfg, params, ed)
    out[f"offline_{model}"] = {"embs": [np.asarray(e).tolist() for e in ed],
                               "bytes": st["bytes_exchanged"]}

cache = ServeCacheConfig(cache_size=8192, ways=4)
base = DistServeConfig(num_slots=8, halo_slots=160, cache=cache)
CASES = {
    "compute": ("graphsage", base, vids),
    "round_batch2": ("graphsage", dataclasses.replace(base, round_batch=2),
                     vids),
    "hot_cold": ("graphsage", dataclasses.replace(base, hot_size=96), vids),
    "gat_compute": ("gat", base, vids),
    "probe_kernel": ("graphsage", dataclasses.replace(base, probe_kernel=True),
                     vids),
    "anomaly": ("graphsage", dataclasses.replace(base, round_batch=2),
                vids_rep),
}
for name, (model, scfg, q) in CASES.items():
    cfg, params, ed = embs[model]
    srv = DistGNNServeScheduler(cfg, params, ps, mesh, scfg)
    srv.cache.warm(ed, all_v, layers=range(cfg.num_layers - 1))
    ans = srv.serve(q)
    m = srv.metrics()
    out[name] = {"out": ans.tolist(), "metrics": {k: m[k] for k in KEYS},
                 "hot_hits": m.get("hot_hits")}

# cache_fetch alone: budgets overrun, two fused rounds, a dead rank
rng = np.random.default_rng(5)
Nf, d, nsets, ways = 40, 6, 16, 4
vids_o = rng.integers(0, 200, (R, Nf)).astype(np.int32)
owner = (vids_o % R).astype(np.int32)
need = rng.random((R, Nf)) < 0.8
h = rng.standard_normal((R, Nf, d)).astype(np.float32)
states = []
for j in range(R):
    st = hec_lib.hec_init(nsets * ways, ways, d)
    mine = np.unique(vids_o[owner == j])
    keep = mine[rng.random(len(mine)) < 0.7].astype(np.int32)
    st = hec_lib.hec_store(st, jnp.asarray(keep), jnp.asarray(
        rng.standard_normal((len(keep), d)).astype(np.float32)))
    states.append(st)
stacked = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *states)
engine = HaloExchangeEngine(R, 1, push_limit=3)
fetch = {"tags": np.asarray(stacked.tags).tolist(),
         "values": np.asarray(stacked.values).tolist(),
         "vids_o": vids_o.tolist(), "need": need.tolist(),
         "h": h.tolist()}
for tag, alive in (("all", None), ("dead2", np.array([1, 1, 0, 1], bool))):
    def body(state, v, o, nd, hh, al):
        sq = lambda t: jax.tree_util.tree_map(lambda a: a[0], t)
        h2, got, nreq = engine.cache_fetch(
            sq(state), v[0], o[0], nd[0], hh[0], rounds=2,
            alive=None if alive is None else al)
        return h2[None], got[None], nreq[None]
    f = jax.jit(compat.shard_map(
        body, mesh=mesh, in_specs=(P("data"),) * 5 + (P(),),
        out_specs=(P("data"),) * 3))
    h2, got, nreq = f(stacked, jnp.asarray(vids_o), jnp.asarray(owner),
                      jnp.asarray(need), jnp.asarray(h),
                      jnp.asarray(np.ones(R, bool) if alive is None
                                  else alive))
    fetch[tag] = {"h": np.asarray(h2).tolist(),
                  "got": np.asarray(got).tolist(),
                  "nreq": np.asarray(nreq).tolist()}
out["cache_fetch"] = fetch
print("RESULT" + json.dumps(out))
"""

CASES = {
    "compute": ("graphsage", {}, "vids"),
    "round_batch2": ("graphsage", {"round_batch": 2}, "vids"),
    "hot_cold": ("graphsage", {"hot_size": 96}, "vids"),
    "gat_compute": ("gat", {}, "vids"),
    # the reference's batched Pallas probe; the port's fetch always runs J
    "probe_kernel": ("graphsage", {}, "vids"),
    "anomaly": ("graphsage", {"round_batch": 2}, "vids_rep"),
}
KEYS = ("steps_run", "fast_path_hits", "halo_seen", "halo_fetched",
        "halo_local_hits", "halo_requested", "hits_l1", "hits_l2",
        "lookups_l1", "lookups_l2", "occupancy_l1", "occupancy_l2")


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", _REF_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("RESULT")][-1]
    return json.loads(line[len("RESULT"):])


@pytest.fixture(scope="module")
def world():
    """The port's side: the same graph, partitions, configs and weights
    (numpy seed 0, ``init="numpy"``, as the reference's side loads them),
    and the distributed offline embeddings."""
    g = synthetic_graph(num_vertices=900, avg_degree=2, num_classes=5,
                        feat_dim=16, seed=3)
    part = partition_graph(g, 1, seed=0).parts[0]
    ps = partition_graph(g, R, seed=0)
    max_deg = int((part.indptr[1:] - part.indptr[:-1]).max())
    out = {"g": g, "part": part, "ps": ps}
    for model in ("graphsage", "gat"):
        cfg = small_gnn_config(model, batch_size=16, feat_dim=16,
                               num_classes=5, fanouts=(max_deg, max_deg),
                               hidden_size=32)
        net = build_model(cfg, seed=0, device="cpu", init="numpy")
        ed, st = layerwise_embeddings_dist(cfg, net, ps, chunk_size=128,
                                           with_stats=True)
        out[model] = (cfg, net, ed, st)
    vids = np.arange(0, 900, 7)
    out["vids"] = vids
    out["vids_rep"] = np.concatenate([np.repeat(vids[:40], 2), vids[40:]])
    return out


def dist_server(world, model, warm_layers="hidden", **over):
    cfg, net, ed, _ = world[model]
    scfg = DistServeConfig(num_slots=8, halo_slots=160,
                           cache=ServeCacheConfig(cache_size=8192, ways=4),
                           **over)
    srv = DistGNNServeScheduler(cfg, net, world["ps"], scfg, device="cpu")
    layers = range(cfg.num_layers - 1) if warm_layers == "hidden" else None
    srv.cache.warm(ed, np.arange(900), layers=layers)
    return srv


@pytest.mark.parametrize("model", ["graphsage", "gat"])
def test_dist_offline_matches_reference_and_single_rank(reference, world,
                                                        model):
    """Sharded layer-wise inference: within 1e-5 of the reference's, the
    same bytes exchanged, one exchange per layer, and bit-equal to the
    port's own single-rank offline engine on the unpartitioned graph."""
    cfg, net, ed, st = world[model]
    ref = reference[f"offline_{model}"]
    assert st["bytes_exchanged"] == ref["bytes"] > 0
    assert st["exchanges"] == cfg.num_layers
    for e, w in zip(ed, ref["embs"]):
        np.testing.assert_allclose(e.numpy(), np.asarray(w, np.float32),
                                   **TOL)
    single = layerwise_embeddings(cfg, net, world["part"], chunk_size=128)
    for a, b in zip(ed, single):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", list(CASES))
def test_scheduler_matches_reference(reference, world, case):
    """Hidden-layer warm, queries on the compute path: answers within 1e-5
    of the reference's and steps, hits, lookups, halo counters and
    occupancies equal — round batching, a cold hot tier and the anomaly
    stream included."""
    model, over, stream = CASES[case]
    srv = dist_server(world, model, **over)
    got = srv.serve(world[stream])
    ref = reference[case]
    np.testing.assert_allclose(got, np.asarray(ref["out"], np.float32),
                               **TOL)
    m = srv.metrics()
    assert {k: m[k] for k in KEYS} == ref["metrics"]
    if case == "hot_cold":
        assert m["hot_hits"] == ref["hot_hits"] == 0
    exact = world[model][2][-1].numpy()[world[stream]]
    err = np.abs(got - exact).max(axis=1)
    if case == "anomaly":
        # the reference's inexact answer, reproduced (ROADMAP.md section 3)
        ref_err = np.abs(np.asarray(ref["out"], np.float32) - exact) \
            .max(axis=1)
        np.testing.assert_array_equal(err > 1e-4, ref_err > 1e-4)
        assert list(world[stream][err > 1e-4]) == [700]
    else:
        assert err.max() < 1e-4


def test_cache_fetch_matches_reference(reference):
    """``cache_fetch`` alone, over budget (3 slots x 2 rounds per pair for
    ~8 wanted rows), with every rank alive and with rank 2 dead: the
    substituted rows, the answered mask and the request counts bit for
    bit."""
    f = reference["cache_fetch"]
    state = hec.HECState(
        tags=torch.as_tensor(np.asarray(f["tags"], np.int32)),
        age=torch.zeros(np.asarray(f["tags"]).shape, dtype=torch.int32),
        values=torch.as_tensor(np.asarray(f["values"], np.float32)))
    vids = torch.as_tensor(np.asarray(f["vids_o"], np.int32))
    owner = vids % R
    need = torch.as_tensor(np.asarray(f["need"], bool))
    h = torch.as_tensor(np.asarray(f["h"], np.float32))
    eng = HaloExchangeEngine(R, 1, push_limit=3)
    for tag, alive in (("all", None),
                       ("dead2", torch.tensor([True, True, False, True]))):
        h2, got, nreq = eng.cache_fetch(state, vids, owner, need, h,
                                        rounds=2, alive=alive)
        want = f[tag]
        np.testing.assert_array_equal(bits(h2.numpy()),
                                      bits(np.asarray(want["h"],
                                                      np.float32)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want["got"]))
        np.testing.assert_array_equal(nreq.numpy(), np.asarray(want["nreq"]))
    assert (nreq < 6 * R).all() and got.any() and (need & ~got).any()


# ---------------------------------------------------------------------------
# where the reference cannot run here: the reference test's own contract
# ---------------------------------------------------------------------------
def test_hot_tier_dedup_round_batch_bitmatch(world):
    """Hot tier warmed on every shard + dedup + round_batch=2 on the repeat
    stream bit-match the features-off scheduler, in fewer rounds and with
    fewer requested rows."""
    _, _, ed, _ = world["graphsage"]
    base = dist_server(world, "graphsage")
    opt = dist_server(world, "graphsage", hot_size=96, dedup=True,
                      round_batch=2)
    assert opt.hot.warm(ed) == 96
    out_base = base.serve(world["vids_rep"])
    out_opt = opt.serve(world["vids_rep"])
    np.testing.assert_array_equal(bits(out_opt), bits(out_base))
    mo, mb = opt.metrics(), base.metrics()
    assert mo["dedup_merged"] > 0 and mo["hot_hits"] > 0
    assert mo["steps_run"] < mb["steps_run"]
    assert mo["halo_requested"] < mb["halo_requested"]


def test_warmed_dist_serving_bitmatches_single_rank(world):
    """Fully warmed sharded serving and the port's single-rank scheduler
    give the same bits (both from the output cache, no compute round);
    latency counters fill."""
    cfg, net, ed, _ = world["graphsage"]
    srv = dist_server(world, "graphsage", warm_layers="all")
    out_d = srv.serve(world["vids"])
    s1 = GNNServeScheduler(cfg, net, world["part"], GNNServeConfig(
        num_slots=8, cache=ServeCacheConfig(cache_size=8192, ways=4)),
        device="cpu")
    warm_cache(s1.cache, layerwise_embeddings(cfg, net, world["part"],
                                              chunk_size=128),
               np.arange(900))
    np.testing.assert_array_equal(bits(out_d), bits(s1.serve(world["vids"])))
    m = srv.metrics()
    assert m["steps_run"] == 0 and m["fast_path_hits"] == len(world["vids"])
    assert m["fast_path_rounds"] > 0
    assert m["latency_count"] == m["fast_path_hits"]
    assert m["latency_p99_ms"] >= m["latency_p50_ms"] > 0.0


def test_output_cache_hits_after_compute_rounds(world):
    """Serving a stream twice: the second pass answers every query from the
    output cache the first pass stored to, with the first pass's bits;
    one-rank routing runs ceil(n / slots) rounds with the other shards
    empty."""
    cfg, _, ed, _ = world["gat"]
    srv = dist_server(world, "gat", dedup=True)
    first = srv.serve(world["vids_rep"])
    steps, fast = srv.steps_run, srv.metrics()["fast_path_hits"]
    assert fast > 0        # repeats split across rounds hit already
    second = srv.serve(world["vids_rep"])
    np.testing.assert_array_equal(bits(first), bits(second))
    assert srv.steps_run == steps
    assert srv.metrics()["fast_path_hits"] - fast == len(world["vids_rep"])
    np.testing.assert_allclose(first, ed[-1].numpy()[world["vids_rep"]],
                               atol=1e-4, rtol=0)
    one = dist_server(world, "gat")
    r0 = world["ps"].parts[0].solid_vids[:20]
    np.testing.assert_allclose(one.serve(r0), ed[-1].numpy()[r0], atol=1e-4,
                               rtol=0)
    assert one.steps_run == int(np.ceil(len(r0) / 8))


def test_update_params_empties_every_shard_and_replica(world):
    cfg, net, ed, _ = world["graphsage"]
    srv = dist_server(world, "graphsage", hot_size=96)
    srv.hot.warm(ed)
    pre = srv.serve(world["vids"])
    net2 = build_model(cfg, seed=9, device="cpu")
    assert srv.update_params(net2) == 1
    m = srv.metrics()
    assert max(m[f"occupancy_l{k}"] for k in (1, 2)) == 0.0
    assert max(m[f"hot_valid_l{k}"] for k in (1, 2)) == 0.0
    assert all(float(st.age.min()) == hot_tier.NEVER
               for st in srv.hot.states)
    post = srv.serve(world["vids"])
    fresh = DistGNNServeScheduler(
        cfg, net2, world["ps"], srv.scfg, device="cpu").serve(world["vids"])
    np.testing.assert_array_equal(bits(post), bits(fresh))
    assert not np.allclose(post, pre, atol=1e-3)


def test_prewarm_failover_and_device_rules(world, monkeypatch):
    """``prewarm`` routes the offline rows to their owners and fills every
    replica; ``failover=True`` builds the rank breaker, every rank alive
    (``tests/test_torch_resilience.py`` drives it); without a card the
    scheduler and the stacked cache raise instead of falling back."""
    cfg, net, _, _ = world["gat"]
    srv = DistGNNServeScheduler(cfg, net, world["ps"], DistServeConfig(
        num_slots=8, hot_size=32, cache=ServeCacheConfig(cache_size=8192,
                                                         ways=4)),
        device="cpu")
    n = prewarm(srv, policy="degree", chunk_size=128)
    assert n == sum(max(1, round(p.num_solid * 0.25))
                    for p in world["ps"].parts)
    assert all(v.all() for v in srv.hot.valid)
    fo = DistGNNServeScheduler(cfg, net, world["ps"],
                               DistServeConfig(failover=True), device="cpu")
    assert fo.breaker.alive.all() and fo.metrics()["dead_ranks"] == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistGNNServeScheduler(cfg, net, world["ps"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EmbeddingCache([4], 900, ps=world["ps"])


def test_launcher_flow_on_cpu():
    from repro_torch.launch import gnn_serve_dist
    args = gnn_serve_dist.parse_args(["--device", "cpu", "--vertices",
                                      "3000"])
    assert (args.ranks, args.slots, args.halo_slots, args.queries,
            args.overlap, args.cache_size, args.hot_size, args.round_batch,
            args.no_dedup) == (4, 32, 256, 1024, 0.5, 65536, 2048, 4, False)
    res = gnn_serve_dist.run(args)
    srv = res["srv"]
    for name in ("serve", "repeat"):
        assert all(r.done and np.isfinite(r.result).all() for r in res[name])
    m = res["serve_metrics"]
    assert m["steps_run"] > 0 and m["dedup_merged"] > 0
    assert m["hot_fast_path_hits"] > 0 and m["halo_seen"] > 0
    assert res["repeat_metrics"]["steps_run"] < m["steps_run"] or \
        res["repeat_metrics"]["fast_path_hits"] > m["fast_path_hits"]
    assert res["prewarmed"] > 0 and res["warmup_metrics"]["steps_run"] > 0
    assert len(srv.round_log) == res["repeat_metrics"]["steps_run"]
