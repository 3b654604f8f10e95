"""The trainer's other modes against the reference, on the CPU: ``sync``
and ``drop``, the hot tier in ``aep`` training and an ``evaluate`` that
copies no HEC.

The same numpy inputs go through ``repro`` and ``repro_torch``.  One
reference subprocess with four forced host devices (as
``tests/test_torch_train.py`` runs its trainer) records the reference
trainer in ``sync`` and ``drop`` for both models at R=1 and R=4 (and
``evaluate`` at R=4), in ``aep`` with the hot tier (``hot_size=48,
hot_budget=32`` on ``tests/test_comm.py``'s graph) for both models at
R=4, and its collectives' pieces at R=4 (``sync_fetch`` and the fused
push with the hot segment) on recorded inputs.  The plan tables and the hot selection
need no collective and run in this process.

Tolerances: integer and data-movement outputs bit for bit (HEC tags and
ages, hot-tier slot ages, pushed and hot tags, fetched rows, hit counts,
metric keys); the loss within 1e-5 relative, the parameters within
rtol/atol 1e-4 and Adam's first moment (the gradient) within 1e-5
relative in norm (GAT: each step from the reference's state, held as
``tests/test_torch_train.py`` holds it).  The port against itself
(inline and threaded sampling, ``evaluate`` against the clone path) bit
for bit.
"""
import dataclasses
import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm.engine import HaloExchangeEngine as JEngine
from repro.comm.plan import build_exchange_plan as j_plan
from repro.configs.gnn import HECConfig as JHECConfig
from repro.configs.gnn import small_gnn_config as j_small_config
from repro.graph import partition_graph as j_partition_graph
from repro.graph import synthetic_graph as j_synthetic_graph
from repro.pipeline.vectorized_sampler import \
    sample_blocks_vectorized as j_sample
from repro.train.gnn_trainer import build_dist_data as j_build
from repro_torch.cache import hec
from repro_torch.cache import hot_tier
from repro_torch.comm import HaloExchangeEngine, StackedCollective
from repro_torch.comm.plan import build_exchange_plan
from repro_torch.configs.gnn import HECConfig, small_gnn_config
from repro_torch.graph import partition_graph, synthetic_graph
from repro_torch.pipeline.prefetcher import SamplingPlan
from repro_torch.pipeline.staging import EVAL_EPOCH_TAG, eval_schedule
from repro_torch.train.gnn_trainer import (DistTrainer, build_dist_data,
                                           default_push_uniforms,
                                           minibatch_to_device)
from test_torch_train import (PARAM_NAMES, bits, check_adam_step,
                              load_reference_step, stacked)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
t = torch.as_tensor
STEPS = 3
SYNC_SLOTS = (64, 1100)     # nc of the sync fetch cases: 1100 > the halos
HOT = dict(hot_size=48, hot_budget=32)

_REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P
from repro.comm.engine import HaloExchangeEngine
from repro.configs.gnn import HECConfig, small_gnn_config
from repro.graph import partition_graph, synthetic_graph
from repro.pipeline.staging import MinibatchPipeline
from repro.train.gnn_trainer import DistTrainer, build_dist_data
from repro.utils import compat

STEPS = int(sys.argv[2])
out = {}
g = synthetic_graph(num_vertices=1500, avg_degree=8, num_classes=6,
                    feat_dim=24, seed=0)


def config(model, **hot):
    return small_gnn_config(model, batch_size=32, feat_dim=24, num_classes=6,
                            hec=HECConfig(cache_size=4096, ways=4,
                                          life_span=2, push_limit=256,
                                          delay=1, **hot))


def batches(pipe):
    ep = 0
    while True:
        yield from pipe.epoch_batches(ep)
        ep += 1


runs = [(mode, m, R, {}) for mode in ("sync", "drop")
        for m in ("graphsage", "gat") for R in (1, 4)]
runs += [("hot", m, 4, {"hot_size": 48, "hot_budget": 32})
         for m in ("graphsage", "gat")]
for mode, model, R, hot in runs:
    cfg = config(model, **hot)
    ps = partition_graph(g, R, seed=0)
    dd = build_dist_data(ps, cfg)
    mesh = Mesh(np.array(jax.devices()[:R]), ("data",))
    tr = DistTrainer(cfg=cfg, mesh=mesh, num_ranks=R,
                     mode="aep" if mode == "hot" else mode)
    st = tr.init_state(jax.random.key(0), dd)
    pre = f"{mode}/{model}/r{R}"
    step_fn = tr.make_step(dd, donate=False)
    pipe = MinibatchPipeline(ps, cfg, base_seed=0, mesh=mesh)
    for i, mb in zip(range(STEPS), batches(pipe)):
        (st["params"], st["opt_state"], st["hec"], st["hot"],
         st["inflight"], _, metrics) = step_fn(
            st["params"], st["opt_state"], st["hec"], st["hot"],
            st["inflight"], dd, mb, jnp.uint32(i))
        for k, v in metrics.items():
            out[f"{pre}/m/{i}/{k}"] = np.asarray(v)
        for l, layer in enumerate(st["params"]["layers"]):
            for n, v in layer.items():
                out[f"{pre}/params/{i}/{l}/{n}"] = np.asarray(v)
                for mom in ("mu", "nu"):
                    out[f"{pre}/{mom}/{i}/{l}/{n}"] = np.asarray(
                        st["opt_state"][mom]["layers"][l][n])
        for l, h in enumerate(st["hec"]):
            for f in ("tags", "age", "values"):
                out[f"{pre}/{f}/{i}/{l}"] = np.asarray(getattr(h, f))
        for l, h in enumerate(st["hot"]):
            for f in ("age", "values"):
                out[f"{pre}/hot_{f}/{i}/{l}"] = np.asarray(getattr(h, f))
        for k, v in st["inflight"].items():
            if k.endswith("tags"):
                out[f"{pre}/inflight_{k}/{i}"] = np.asarray(v)
    if R > 1:                  # one rank has no halo: every mode the same
        out[f"{pre}/eval_acc"] = np.asarray(tr.evaluate(ps, dd, st,
                                                        num_batches=2))

# the collectives' pieces at R=4 on recorded inputs
R = 4
mesh = Mesh(np.array(jax.devices()[:R]), ("data",))
shard = P("data")
sq = lambda x: jax.tree_util.tree_map(lambda a: a[0], x)
ps = partition_graph(g, R, seed=0)
dd = build_dist_data(ps, config("graphsage"))
mb = next(batches(MinibatchPipeline(ps, config("graphsage"), base_seed=0,
                                    mesh=mesh)))
nodes0 = np.asarray(mb["layer_nodes"][0])
mask0 = np.asarray(mb["node_mask"][0])
num_solid = np.asarray(dd["num_solid"])[:, None]
vid_o = np.asarray(dd["vid_o"])
feats = np.asarray(dd["features"])
is_halo0 = (nodes0 >= num_solid) & mask0
vid0 = np.where(nodes0 >= 0, np.take_along_axis(
    vid_o, np.clip(nodes0, 0, vid_o.shape[1] - 1), 1), -1).astype(np.int32)
keep = mask0 & ~is_halo0
h0 = feats[np.arange(R)[:, None], np.clip(nodes0, 0, feats.shape[1] - 1)] \
    * keep[..., None]
out["sync/in/vid0"], out["sync/in/is_halo0"] = vid0, is_halo0
out["sync/in/h0"] = h0.astype(np.float32)
tables = {k: dd[k] for k in ("features", "solid_sorted_vids",
                             "solid_sorted_idx")}
for nc in [int(x) for x in sys.argv[3].split(",")]:
    eng = HaloExchangeEngine(R, 2, push_limit=nc)

    def fetch(data, v, ih, h):
        h2, got = eng.sync_fetch(sq(data), v[0], ih[0], h[0])
        return h2[None], got[None]
    f = jax.jit(compat.shard_map(fetch, mesh=mesh, in_specs=(shard,) * 4,
                                 out_specs=(shard, shard)))
    h2, got = f(tables, jnp.asarray(vid0), jnp.asarray(is_halo0),
                jnp.asarray(out["sync/in/h0"]))
    out[f"sync/{nc}/h0"], out[f"sync/{nc}/got"] = np.asarray(h2), \
        np.asarray(got)

L, nc, hb, dmax = 2, 5, 3, 6
rng = np.random.default_rng(0)
tags = rng.integers(-1, 2 ** 30, (R, R, L, nc)).astype(np.int32)
embs = rng.normal(size=(R, R, L, nc, dmax)).astype(np.float32)
h_tags = rng.integers(-1, 48, (R, L, hb)).astype(np.int32)
h_embs = rng.normal(size=(R, L, hb, dmax)).astype(np.float32)
eng = HaloExchangeEngine(R, L, nc, hot_budget=hb)


def push(a, b, c, d):
    return tuple(x[None] for x in eng.push(a[0], b[0], hot=(c[0], d[0])))
f = jax.jit(compat.shard_map(push, mesh=mesh, in_specs=(shard,) * 4,
                             out_specs=(shard,) * 4))
for k, v in zip(("tags", "embs", "h_tags", "h_embs"),
                (tags, embs, h_tags, h_embs)):
    out[f"push/in/{k}"] = v
for k, v in zip(("tags", "embs", "h_tags", "h_embs"),
                f(tags, embs, h_tags, h_embs)):
    out[f"push/out/{k}"] = np.asarray(v)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", _REF_SCRIPT, str(path),
                           str(STEPS), ",".join(map(str, SYNC_SLOTS))],
                          env=env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


def graph():
    return synthetic_graph(num_vertices=1500, avg_degree=8, num_classes=6,
                           feat_dim=24, seed=0)


def config(model, **hot):
    return small_gnn_config(model, batch_size=32, feat_dim=24, num_classes=6,
                            hec=HECConfig(cache_size=4096, ways=4,
                                          life_span=2, push_limit=256,
                                          delay=1, **hot))


def first_batches(ps, cfg, n=STEPS):
    plan = SamplingPlan(ps, cfg, 0)
    return [h for ep in range(2)
            for h in plan.batches(plan.epoch_schedule(ep), ep)][:n]


def sub(ref, prefix):
    return {k.removeprefix(prefix): v for k, v in ref.items()
            if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# the exchange plan, the hot selection and the collectives' pieces
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def hot_parts():
    """``tests/test_comm.py``'s hot-tier graph, cut into 4 parts."""
    kw = dict(num_vertices=900, avg_degree=8, num_classes=4, feat_dim=8,
              seed=2, intra_prob=0.35)
    return (partition_graph(synthetic_graph(**kw), 4, seed=0),
            j_partition_graph(j_synthetic_graph(**kw), 4, seed=0))


@pytest.mark.parametrize("hot_size", [0, 64])
def test_plan_tables_match_reference(hot_parts, hot_size):
    """``push_mask`` (hot vertices removed), the sorted owner tables and
    the hot set bit for bit, and the device tables the trainer reads;
    ``hot_size=0`` leaves the plan as it is without a tier."""
    ps, jps = hot_parts
    got = build_exchange_plan(ps, hot_size=hot_size)
    want = j_plan(jps, hot_size=hot_size)
    for f in ("push_mask", "solid_sorted_vids", "solid_sorted_idx",
              "hot_vids", "hot_owner"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for i in range(4):
        for j in range(4):
            for a, b in ((got.send_local, want.send_local),
                         (got.recv_pos, want.recv_pos)):
                np.testing.assert_array_equal(a[i][j], b[i][j])
    dev = got.device_tables(CPU)
    jdev = want.device_tables()
    assert sorted(dev) == sorted(jdev)
    for k in dev:
        np.testing.assert_array_equal(dev[k].numpy(), np.asarray(jdev[k]))
    base = build_exchange_plan(ps)
    if hot_size:
        assert got.hot_size == hot_size
        assert (got.push_mask <= base.push_mask).all()
        assert (got.push_mask != base.push_mask).any()
    else:
        assert got.hot_size == 0 and "hot_vids" not in dev
        for f in ("push_mask", "num_halo", "solid_sorted_vids",
                  "solid_sorted_idx"):
            a, b = getattr(got, f), getattr(base, f)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", [0, 5])
def test_select_hot_push_matches_reference(hot_parts, seed):
    """The hot-tier selection with the port's own draw of the reference's
    ``PRNGKey(11)`` uniforms: slot tags and rows bit for bit, per rank."""
    ps, jps = hot_parts
    cfg = small_gnn_config("graphsage", batch_size=16, feat_dim=8,
                           num_classes=4, hec=HECConfig(
                               cache_size=256, ways=4, push_limit=40,
                               hot_size=64, hot_budget=6))
    jcfg = j_small_config("graphsage", batch_size=16, feat_dim=8,
                          num_classes=4, hec=JHECConfig(
                              cache_size=256, ways=4, push_limit=40,
                              hot_size=64, hot_budget=6))
    data = build_dist_data(ps, cfg, CPU)
    jdata = j_build(jps, jcfg)
    dims, R, L = [8, 12], 4, 2
    jeng = JEngine(R, L, push_limit=40, hot_budget=6)
    eng = HaloExchangeEngine(R, L, 40, 1, StackedCollective(R), hot_budget=6)
    draw = default_push_uniforms(CPU, base_seed=11)
    rng = np.random.default_rng(seed)
    selected = 0
    for r in range(R):
        seeds = np.flatnonzero(ps.parts[r].train_mask)[:16]
        mb = j_sample(jps.parts[r], seeds, (3, 3), rng, 16)
        nodes = [n.astype(np.int32) for n in mb.layer_nodes]
        vid_o = np.asarray(jdata["vid_o"][r])
        vid_nodes = [np.where(n >= 0, vid_o[np.clip(n, 0, len(vid_o) - 1)],
                              -1).astype(np.int32) for n in nodes]
        captured = [(rng.normal(size=(len(nodes[l]), dims[l]))
                     .astype(np.float32), rng.random(len(nodes[l])) > 0.2)
                    for l in range(L)]
        jd = {k: v[r] for k, v in jdata.items()}
        want = jeng.select_hot_push(
            jd, {"layer_nodes": [jnp.asarray(n) for n in nodes],
                 "node_mask": [jnp.asarray(m) for m in mb.node_mask]},
            {l: tuple(map(jnp.asarray, c)) for l, c in enumerate(captured)},
            [jnp.asarray(v) for v in vid_nodes], jd["num_solid"],
            jnp.uint32(seed), dims, 12, jnp.int32(r))
        got = eng.select_hot_push(
            data["hot_vids"][r], data["hot_mine"][r], t(nodes[0]),
            t(mb.node_mask[0]), t(vid_nodes[0]), data["num_solid"][r],
            [tuple(map(t, c)) for c in captured],
            draw(seed, r, (len(nodes[0]),)), dims, 12)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(bits(a), bits(b))
        selected += int((got[0] >= 0).sum())
    assert selected > 0


def test_push_with_hot_segment_matches_reference(reference_run):
    """The fused all_to_all with the broadcast segment at R=4: received
    tags, rows, hot slots and hot rows bit for bit; then ``aep_push``
    queues them and counts the hot rows sent to the other ranks."""
    ref = sub(reference_run, "push/")
    R = ref["in/tags"].shape[0]
    hb = ref["in/h_tags"].shape[-1]
    eng = HaloExchangeEngine(R, 2, 5, 1, StackedCollective(R), hot_budget=hb)
    ins = [t(ref[f"in/{k}"]) for k in ("tags", "embs", "h_tags", "h_embs")]
    got = eng.push(ins[0], ins[1], hot=(ins[2], ins[3]))
    for a, k in zip(got, ("tags", "embs", "h_tags", "h_embs")):
        np.testing.assert_array_equal(bits(a.numpy()), bits(ref[f"out/{k}"]))
    q = eng.inflight_init(ref["in/embs"].shape[-1], CPU)
    q, stats = eng.aep_push([(ins[0][r], ins[1][r]) for r in range(R)], q,
                            [6, 4], hot=[(ins[2][r], ins[3][r])
                                         for r in range(R)])
    for r in range(R):
        np.testing.assert_array_equal(q[r]["hot_tags"][-1].numpy(),
                                      ref["out/h_tags"][r])
    np.testing.assert_array_equal(
        stats["hot_push_rows"].numpy(),
        (ref["in/h_tags"] >= 0).sum(axis=(1, 2)) * (R - 1))


@pytest.mark.parametrize("nc", SYNC_SLOTS)
def test_sync_fetch_matches_reference(reference_run, nc):
    """The sync fetch at R=4 on the first minibatch: fetched rows and
    ``got`` bit for bit.  At nc=1100 every rank has fewer halos than
    slots, so the unused slots tie at -1: ``torch.topk`` and
    ``lax.top_k`` may take other positions there, and the mask makes them
    all the same."""
    ref = sub(reference_run, "sync/")
    ps = partition_graph(graph(), 4, seed=0)
    data = build_dist_data(ps, config("graphsage"), CPU)
    is_halo0 = t(ref["in/is_halo0"])
    eng = HaloExchangeEngine(4, 2, nc, 1, StackedCollective(4))
    h0, got = eng.sync_fetch(data["solid_sorted_vids"],
                             data["solid_sorted_idx"], data["features"],
                             t(ref["in/vid0"]), is_halo0, t(ref["in/h0"]))
    np.testing.assert_array_equal(bits(h0.numpy()), bits(ref[f"{nc}/h0"]))
    np.testing.assert_array_equal(got.numpy(), ref[f"{nc}/got"])
    halos = is_halo0.sum(1)
    assert int(got.sum()) == int(halos.clamp(max=nc).sum()) > 0
    if nc == max(SYNC_SLOTS):
        assert (halos < nc).all()
    # the fetched rows are the owners' feature rows
    r, p = [int(x[0]) for x in torch.nonzero(got).T]
    vid = int(ref["in/vid0"][r, p])
    owner, local = ps.route(np.array([vid]))
    np.testing.assert_array_equal(h0[r, p].numpy(),
                                  ps.parts[owner[0]].features[local[0]])


# ---------------------------------------------------------------------------
# the trainer in every mode against the reference
# ---------------------------------------------------------------------------
def run_against_reference(ref, mode, model, R, **hot):
    """Free steps for GraphSAGE, GAT from the reference's state each step
    (``check_adam_step``); every step's metric keys, counts, loss, HEC
    tags and ages, and the queue's tags against the reference's."""
    ps = partition_graph(graph(), R, seed=0)
    cfg = config(model, **hot)
    data = build_dist_data(ps, cfg, CPU)
    tr = DistTrainer(cfg, R, mode=mode, device="cpu")
    st = tr.init_state(seed=0, dist_data=data)
    for i, host in enumerate(first_batches(ps, cfg)):
        if model == "gat" and i:
            load_reference_step(st, ref, model, i - 1)
        m = tr.train_step(st, data, minibatch_to_device(host, CPU), i)
        want_keys = {k.split("/", 2)[2] for k in ref
                     if k.startswith(f"m/{i}/")}
        assert set(m) == want_keys, (i, sorted(set(m) ^ want_keys))
        want = float(ref[f"m/{i}/loss"])
        assert abs(m["loss"] - want) <= 1e-5 * abs(want), (i, m["loss"])
        for k in m:
            if k.startswith(("hec_hits", "hec_halos", "hot_", "aep_push",
                             "exam")):
                assert m[k] == float(ref[f"m/{i}/{k}"]), (i, k)
        if model == "gat":
            check_adam_step(st, ref, model, i, cfg.lr)
        else:
            k = 0
            for l, layer in enumerate(st["model"].layers):
                for n in sorted(PARAM_NAMES[model]):     # the leaf order
                    np.testing.assert_allclose(
                        getattr(layer, n).detach().numpy(),
                        ref[f"params/{i}/{l}/{n}"], rtol=1e-4, atol=1e-4)
                    mu, want = st["opt"].mu[k].numpy(), ref[f"mu/{i}/{l}/{n}"]
                    assert np.linalg.norm(mu - want) <= \
                        1e-5 * np.linalg.norm(want), (i, l, n)
                    k += 1
        for l in range(cfg.num_layers):
            for f in ("tags", "age"):
                np.testing.assert_array_equal(stacked(st, f, l),
                                              ref[f"{f}/{i}/{l}"])
            np.testing.assert_allclose(stacked(st, "values", l),
                                       ref[f"values/{i}/{l}"], rtol=1e-4,
                                       atol=1e-4)
        for l, tier in enumerate(st["hot"]):
            np.testing.assert_array_equal(tier.age.numpy(),
                                          ref[f"hot_age/{i}/{l}"])
            np.testing.assert_allclose(tier.values.numpy(),
                                       ref[f"hot_values/{i}/{l}"],
                                       rtol=1e-4, atol=1e-4)
        for k in ("tags", "hot_tags"):
            if f"inflight_{k}/{i}" in ref:
                np.testing.assert_array_equal(
                    torch.stack([q[k] for q in st["inflight"]]).numpy(),
                    ref[f"inflight_{k}/{i}"])
            else:
                assert k == "hot_tags" and "hot_tags" not in \
                    st["inflight"][0]
    if "eval_acc" in ref:
        if model == "gat":
            load_reference_step(st, ref, model, STEPS - 1)
        acc = tr.evaluate(ps, data, st, num_batches=2)
        assert acc == pytest.approx(float(ref["eval_acc"]), abs=1e-6)
    return m, st


@pytest.mark.parametrize("mode,model,R", [
    (mode, m, R) for mode in ("sync", "drop") for m in ("graphsage", "gat")
    for R in (1, 4)])
def test_sync_and_drop_three_steps_match_reference(reference_run, mode,
                                                   model, R):
    """Outside ``aep`` the HECs stay empty and only layer 0 counts halos
    (``hec_hits_l0``/``hec_halos_l0``); ``sync`` fetches up to nc = 256
    halos per rank, ``drop`` none; no push metrics."""
    ref = sub(reference_run, f"{mode}/{model}/r{R}/")
    m, st = run_against_reference(ref, mode, model, R)
    assert not any(k.startswith(("aep_push", "hec_hits_l1")) for k in m)
    assert all((s.tags < 0).all() for layer in st["hec"] for s in layer)
    if R == 4:
        assert m["hec_halos_l0"] > 0
        assert (m["hec_hits_l0"] > 0) == (mode == "sync")


@pytest.mark.parametrize("model", ["graphsage", "gat"])
def test_hot_tier_three_steps_match_reference(reference_run, model):
    """``aep`` with the hot tier at R=4: the tier's slot ages, the queued
    hot slots, ``hot_hits_l{l}`` and ``hot_push_rows`` equal the
    reference's, with the HEC as in the other modes."""
    ref = sub(reference_run, f"hot/{model}/r4/")
    m, st = run_against_reference(ref, "aep", model, 4, **HOT)
    assert len(st["hot"]) == 2 and m["hot_push_rows"] > 0
    assert sum(m[f"hot_hits_l{l}"] for l in range(2)) > 0


# ---------------------------------------------------------------------------
# the port against itself: sampling workers, evaluate, the tier's rules
# ---------------------------------------------------------------------------
def full_state(st):
    """Every tensor of a training state, host copies in a fixed order."""
    out = [p.detach().clone() for p in st["model"].parameter_list()]
    out += [x.clone() for x in st["opt"].mu + st["opt"].nu]
    out += [getattr(s, f).clone() for layer in st["hec"] for s in layer
            for f in ("tags", "age", "values")]
    out += [getattr(s, f).clone() for s in st["hot"]
            for f in ("age", "values")]
    out += [q[k].clone() for q in st["inflight"] for k in sorted(q)]
    return out


def same_bits(a, b):
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.view(torch.int32) if x.dtype == torch.float32
                        else x, y.view(torch.int32)
                        if y.dtype == torch.float32 else y)
        for x, y in zip(a, b))


@pytest.mark.parametrize("mode,hot", [("sync", False), ("aep", True)],
                         ids=["sync", "aep-hot"])
def test_modes_bit_equal_across_sampling_workers(mode, hot):
    """One epoch of ``train_epochs`` at R=4 with the minibatches drawn
    inline and by three prefetch threads: params, Adam, HECs, hot
    replicas and queue, the loss history and every step's metrics are
    bit-equal, so the sync fetch and the tier's push read nothing that
    depends on the sampling schedule."""
    ps = partition_graph(graph(), 4, seed=0)
    base = config("graphsage", **(HOT if hot else {}))
    out = {}
    for workers in (0, 3):
        cfg = dataclasses.replace(base, pipeline=dataclasses.replace(
            base.pipeline, num_workers=workers, prefetch_depth=2))
        data = build_dist_data(ps, cfg, CPU)
        tr = DistTrainer(cfg, 4, mode=mode, device="cpu")
        st = tr.init_state(seed=0, dist_data=data)
        st, hist = tr.train_epochs(ps, data, st, 1)
        out[workers] = (full_state(st), [h["loss"] for h in hist],
                        [m for m in tr.step_log])
    assert same_bits(out[0][0], out[3][0])
    assert out[0][1] == out[3][1]
    assert out[0][2] == out[3][2]
    assert bool(st["hot"]) == hot


def evaluate_by_clones(tr, ps, data, st, num_batches):
    """The clone path: each batch consumes into copies of the HECs and the
    tier, and forwards on them."""
    plan = SamplingPlan(ps, tr.cfg, base_seed=123, device=tr.device)
    accs, weights = [], []
    for k, host in enumerate(plan.batches(eval_schedule(plan, num_batches,
                                                             123),
                                          EVAL_EPOCH_TAG + 123)):
        mb = minibatch_to_device(host, CPU)
        copy = dict(st, hec=[[hec.hec_clone(s) for s in layer]
                             for layer in st["hec"]],
                    hot=[hot_tier.HotTierState(values=s.values.clone(),
                                               age=s.age.clone())
                         for s in st["hot"]])
        with torch.no_grad():
            if tr.mode == "aep":
                tr._consume(copy)
            fwd = tr._forward(copy, data, mb, 10_000 + k, 0.0)
        n = sum(int(f.n_valid) for f in fwd)
        accs.append(sum(int(f.correct) for f in fwd) / max(n, 1))
        weights.append(float(n))
    return float(np.average(accs, weights=weights))


@pytest.mark.parametrize("mode,hot", [("aep", False), ("aep", True),
                                      ("sync", False), ("drop", False)],
                         ids=["aep", "aep-hot", "sync", "drop"])
def test_evaluate_without_clones_matches_clone_path(mode, hot):
    """After two training steps (a filled HEC and queue): ``evaluate``'s
    accuracy equals the clone path's, and the whole training state after
    it is bit-equal to the state before.  ``evaluate`` never calls
    ``hec_clone``."""
    ps = partition_graph(graph(), 4, seed=0)
    cfg = config("graphsage", **(HOT if hot else {}))
    data = build_dist_data(ps, cfg, CPU)
    tr = DistTrainer(cfg, 4, mode=mode, device="cpu")
    st = tr.init_state(seed=0, dist_data=data)
    for i, host in enumerate(first_batches(ps, cfg, 2)):
        tr.train_step(st, data, minibatch_to_device(host, CPU), i)
    before = full_state(st)
    want = evaluate_by_clones(tr, ps, data, st, 3)
    assert same_bits(full_state(st), before)
    calls = []
    orig = hec.hec_clone
    hec.hec_clone = lambda s: calls.append(s) or orig(s)
    try:
        got = tr.evaluate(ps, data, st, num_batches=3)
    finally:
        hec.hec_clone = orig
    assert got == want and not calls
    assert same_bits(full_state(st), before)
    if mode == "aep":                # the consume did write, and was undone
        assert any((q["tags"][0] >= 0).any() for q in st["inflight"])


def test_init_state_tier_rules():
    """The reference's rules: the tier is off outside ``aep``; on, it
    needs ``dist_data``; no hot set (one rank) turns it off; a budget
    that cannot refresh the busiest owner's hot vertices in a life-span
    warns, one that can does not."""
    ps = partition_graph(graph(), 4, seed=0)
    cfg = config("graphsage", **HOT)
    data = build_dist_data(ps, cfg, CPU)
    for mode in ("sync", "drop"):
        tr = DistTrainer(cfg, 4, mode=mode, device="cpu")
        st = tr.init_state(seed=0, dist_data=data)
        assert st["hot"] == [] and tr.engine.hot_budget == 0
        assert "hot_tags" not in st["inflight"][0]
    with pytest.raises(ValueError, match="dist_data"):
        DistTrainer(cfg, 4, device="cpu").init_state(seed=0)
    one = partition_graph(graph(), 1, seed=0)
    tr = DistTrainer(cfg, 1, device="cpu")
    st = tr.init_state(seed=0, dist_data=build_dist_data(one, cfg, CPU))
    assert st["hot"] == [] and tr.engine.hot_budget == 0
    owned = int(data["hot_mine"].sum(1).max())
    for budget, warns in ((1, True), (-(-owned // 2), False)):
        small = config("graphsage", hot_size=48, hot_budget=budget)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            st = DistTrainer(small, 4, device="cpu").init_state(
                seed=0, dist_data=data)
        assert any("undersized" in str(x.message) for x in w) == warns
        assert [tuple(s.age.shape) for s in st["hot"]] == [(4, 48)] * 2
    with pytest.raises(ValueError, match="together"):
        HECConfig(hot_size=8)
    with pytest.raises(ValueError, match="mode"):
        DistTrainer(cfg, 4, mode="fast", device="cpu")
