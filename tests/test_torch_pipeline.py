"""The port's minibatch pipeline against the reference, on the CPU: the
per-row sampler ``sample_blocks``, the unstaged epoch iterator, the
host draw with ``vectorized=False``, ``device_stage`` and
``MinibatchPipeline``, and the trainer's other paths through them:
``train_epochs(pipeline=None)``, ``PipelineConfig(vectorized=False)``,
``DistTrainer(overlap=False)`` (the push inline after the backward) and
``start_epoch``.  The reference trainer runs in one subprocess with four
forced host devices, as ``tests/test_torch_train.py`` runs it.

Tolerances: minibatches, the generator's state, HEC tags and ages,
queued tags, hits, halos, pushed rows and examples bit for bit; the loss
within 1e-5 relative and the parameters within rtol/atol 1e-4 (torch and
XLA sum float32 in other orders), the evaluate accuracy within 1e-6.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs.gnn import PipelineConfig as JPipelineConfig
from repro.configs.gnn import small_gnn_config as j_small_config
from repro.graph import partition_graph as j_partition_graph
from repro.graph import synthetic_graph as j_synthetic_graph
from repro.graph.sampling import sample_blocks as j_sample_blocks
from repro_torch.configs.gnn import (HECConfig, PipelineConfig,
                                     SamplerConfig, small_gnn_config)
from repro_torch.graph import (partition_graph, sample_blocks,
                               synthetic_graph)
from repro_torch.pipeline.prefetcher import SamplingPlan
from repro_torch.pipeline.staging import MinibatchPipeline, device_stage
from repro_torch.train.data import gnn_epoch_iterator
from repro_torch.train.gnn_trainer import DistTrainer, build_dist_data

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def assert_same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def numpy_batch(mb):
    return {k: [np.asarray(x) for x in v] if isinstance(v, list)
            else np.asarray(v) for k, v in mb.items()}


def assert_same_batch(a, b):
    a, b = numpy_batch(a), numpy_batch(b)
    assert a.keys() == b.keys()
    for k in a:
        for x, y in (zip(a[k], b[k]) if isinstance(a[k], list)
                     else [(a[k], b[k])]):
            assert_same(x, y)


def zero_degree(part, vids):
    """``part`` with the rows of ``vids`` emptied (zero-degree solids)."""
    deg = np.diff(part.indptr)
    keep = np.repeat(~np.isin(np.arange(part.num_solid), vids), deg)
    deg = np.where(np.isin(np.arange(part.num_solid), vids), 0, deg)
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(part.indptr.dtype)
    return dataclasses.replace(part, indptr=indptr,
                               indices=part.indices[keep])


@pytest.fixture(scope="module")
def parts_pair():
    kw = dict(num_vertices=1200, avg_degree=6, num_classes=5, feat_dim=8,
              seed=6)
    return (partition_graph(synthetic_graph(**kw), 3, seed=2),
            j_partition_graph(j_synthetic_graph(**kw), 3, seed=2))


# ---------------------------------------------------------------------------
# the per-row sampler and the unstaged epoch iterator
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fanouts,batch", [((5, 10), 16), ((3, 4, 5), 8),
                                           ((2,), 32)])
@pytest.mark.parametrize("seeds", ["train", "empty", "zero-degree"])
def test_sample_blocks_bit_for_bit(parts_pair, fanouts, batch, seeds):
    """The reference's ``sample_blocks``, bit for bit, on halo-bearing
    partitions, with an empty seed list and with zero-degree vertices
    among the seeds and their neighbours; the shared generator is left
    in the reference's state."""
    ps, jps = parts_pair
    for r in range(ps.num_parts):
        part, jpart = ps.parts[r], jps.parts[r]
        pick = np.random.default_rng(r).choice(part.num_solid, batch,
                                               replace=False)
        if seeds == "zero-degree":
            empty = np.concatenate([pick[::2], np.arange(0, part.num_solid,
                                                         3)])
            part, jpart = zero_degree(part, empty), zero_degree(jpart, empty)
        s = np.empty(0, np.int64) if seeds == "empty" else pick[:batch - r]
        rng, jrng = np.random.default_rng([5, r]), np.random.default_rng(
            [5, r])
        a = sample_blocks(part, s, fanouts, rng, batch)
        b = j_sample_blocks(jpart, s, fanouts, jrng, batch)
        for f in ("layer_nodes", "node_mask", "nbr_idx"):
            for x, y in zip(getattr(a, f), getattr(b, f)):
                assert_same(x, y)
        for f in ("seeds", "seed_mask", "labels"):
            assert_same(getattr(a, f), getattr(b, f))
        assert rng.bit_generator.state == jrng.bit_generator.state
        if seeds == "empty":
            assert not a.seed_mask.any() and (a.layer_nodes[0] < 0).all()


def test_gnn_epoch_iterator_bit_for_bit(parts_pair):
    """Two epochs off one generator: every minibatch, ``imbalance`` and
    ``minibatches`` equal, and the generator left as the reference's."""
    from repro.train.data import gnn_epoch_iterator as j_iter
    ps, jps = parts_pair
    kw = dict(batch_size=16, feat_dim=8, num_classes=5, fanouts=(3, 4))
    cfg, jcfg = small_gnn_config("graphsage", **kw), j_small_config(
        "graphsage", **kw)
    rng, jrng = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(2):
        got, want = list(gnn_epoch_iterator(ps, cfg, rng)), list(
            j_iter(jps, jcfg, jrng))
        assert len(got) == len(want) > 1
        for (mb, info), (jmb, jinfo) in zip(got, want):
            assert_same_batch(mb, jmb)
            assert info == jinfo
    assert rng.bit_generator.state == jrng.bit_generator.state
    assert got[0][1]["minibatches"] == len(got)


@pytest.mark.parametrize("device_draw", [False, True])
def test_sample_host_per_row_sampler_bit_for_bit(parts_pair, device_draw):
    """``SamplingPlan.sample_host`` with ``vectorized=False`` draws with
    ``sample_blocks``, the device draw off even when asked for (as the
    reference), and equals the reference's plan step for step."""
    from repro.configs.gnn import SamplerConfig as JSamplerConfig
    from repro.pipeline.prefetcher import SamplingPlan as JPlan
    ps, jps = parts_pair
    kw = dict(batch_size=16, feat_dim=8, num_classes=5, fanouts=(3, 4))
    plan = SamplingPlan(ps, small_gnn_config("graphsage", **kw, pipeline=(
        PipelineConfig(vectorized=False, sampler=SamplerConfig(
            device_draw=device_draw)))), 3, device="cpu")
    jplan = JPlan(jps, j_small_config("graphsage", **kw, pipeline=(
        JPipelineConfig(vectorized=False, sampler=JSamplerConfig(
            device_draw=device_draw)))), 3)
    for ep in range(2):
        sched, jsched = plan.epoch_schedule(ep), jplan.epoch_schedule(ep)
        for step in range(len(sched)):
            assert_same_batch(plan.sample_host(ep, step, sched[step]),
                              jplan.sample_host(ep, step, jsched[step]))
    assert plan._samplers is None          # no DeviceSampler was made


# ---------------------------------------------------------------------------
# staging and the pipeline
# ---------------------------------------------------------------------------
def test_device_stage_same_batches_either_buffering(parts_pair):
    ps, _ = parts_pair
    cfg = small_gnn_config("graphsage", batch_size=16, feat_dim=8,
                           num_classes=5, fanouts=(3, 4))
    plan = SamplingPlan(ps, cfg, 0)
    hosts = list(plan.batches(plan.epoch_schedule(0), 0))
    assert len(hosts) > 2
    for db in (True, False):
        got = list(device_stage(iter(hosts), db, device="cpu"))
        assert len(got) == len(hosts)
        for a, b in zip(got, hosts):
            assert all(isinstance(x, torch.Tensor) for v in a.values()
                       for x in (v if isinstance(v, list) else [v]))
            assert_same_batch(a, b)
    assert list(device_stage(iter([]), True, device="cpu")) == []


@pytest.mark.parametrize("double_buffer", [True, False])
@pytest.mark.parametrize("workers", [0, 2])
def test_minibatch_pipeline_matches_reference(parts_pair, double_buffer,
                                              workers):
    from repro.pipeline.staging import MinibatchPipeline as JPipeline
    ps, jps = parts_pair
    kw = dict(batch_size=16, feat_dim=8, num_classes=5, fanouts=(3, 4))
    pipe = MinibatchPipeline(ps, small_gnn_config(
        "graphsage", **kw, pipeline=PipelineConfig(
            num_workers=workers, double_buffer=double_buffer)), 7,
        device="cpu")
    jpipe = JPipeline(jps, j_small_config("graphsage", **kw), 7)
    assert pipe.num_ranks == jpipe.num_ranks == 3
    for got, want in ((pipe.epoch_batches(1), jpipe.epoch_batches(1)),
                      (pipe.eval_batches(3, seed=123),
                       jpipe.eval_batches(3, seed=123))):
        got, want = list(got), list(want)
        assert len(got) == len(want) > 1
        for a, b in zip(got, want):
            assert_same_batch(a, b)


def test_resolve_pipeline():
    g = synthetic_graph(num_vertices=300, avg_degree=4, seed=0)
    ps = partition_graph(g, 2, seed=0)
    cfg = small_gnn_config("graphsage")
    tr = DistTrainer(cfg, 2, device="cpu")
    pipe = tr._resolve_pipeline(ps, 3, "auto")
    assert isinstance(pipe, MinibatchPipeline) and pipe.plan.base_seed == 3
    assert not pipe.plan.pin_memory
    assert tr._resolve_pipeline(ps, 3, pipe) is pipe
    assert tr._resolve_pipeline(ps, 3, None) is None
    off = DistTrainer(dataclasses.replace(
        cfg, pipeline=PipelineConfig(enabled=False)), 2, device="cpu")
    assert off._resolve_pipeline(ps, 3, "auto") is None
    assert tr.push_stream is None and off.push_stream is None


# ---------------------------------------------------------------------------
# the trainer's paths against the reference
# ---------------------------------------------------------------------------
CASES = ("none-1", "none-4", "novec-4", "inline-4")
EPOCHS = {1: 1, 4: 2}
_REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import numpy as np
from jax.sharding import Mesh
from repro.configs.gnn import HECConfig, PipelineConfig, small_gnn_config
from repro.graph import partition_graph, synthetic_graph
from repro.train.gnn_trainer import DistTrainer, build_dist_data

EPOCHS = {1: 1, 4: 2}
out = {}
g = synthetic_graph(num_vertices=1500, avg_degree=8, num_classes=6,
                    feat_dim=24, seed=0)
for case in sys.argv[2].split(","):
    name, R = case.split("-")
    R = int(R)
    cfg = small_gnn_config(
        "graphsage", batch_size=32, feat_dim=24, num_classes=6,
        hec=HECConfig(cache_size=4096, ways=4, life_span=2, push_limit=256,
                      delay=1),
        pipeline=PipelineConfig(vectorized=name != "novec"))
    ps = partition_graph(g, R, seed=0)
    dd = build_dist_data(ps, cfg)
    mesh = Mesh(np.array(jax.devices()[:R]), ("data",))
    tr = DistTrainer(cfg=cfg, mesh=mesh, num_ranks=R, mode="aep",
                     overlap=name != "inline")
    st = tr.init_state(jax.random.key(0), dd)
    inner = tr.make_step(dd, donate=False)
    log = []
    def step_fn(*a):
        res = inner(*a)
        pre = f"{case}/{len(log)}"
        log.append(pre)
        params, _, hec, _, inflight, _, metrics = res
        for k, v in metrics.items():
            out[f"{pre}/m/{k}"] = np.asarray(v)
        for l, layer in enumerate(params["layers"]):
            for n, v in layer.items():
                out[f"{pre}/p/{l}/{n}"] = np.asarray(v)
        for l, h in enumerate(hec):
            out[f"{pre}/tags/{l}"] = np.asarray(h.tags)
            out[f"{pre}/age/{l}"] = np.asarray(h.age)
        out[f"{pre}/inflight"] = np.asarray(inflight["tags"])
        return res
    pipe = None if name == "none" else "auto"
    st, hist = tr.train_epochs(ps, dd, st, EPOCHS[R], step_fn=step_fn,
                               pipeline=pipe)
    out[f"{case}/steps"] = np.asarray(len(log))
    for e, h in enumerate(hist):
        out[f"{case}/hist/{e}/loss"] = np.asarray(h["loss"])
        out[f"{case}/hist/{e}/rate"] = np.asarray(h.get("hec_hit_rate_l0",
                                                        -1.0))
    if case == "none-4":
        out[f"{case}/eval"] = np.asarray(tr.evaluate(ps, dd, st,
                                                     num_batches=2,
                                                     pipeline=None))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", _REF_SCRIPT, str(path),
                           ",".join(CASES)], env=env, capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


def port_setup(case):
    name, R = case.split("-")
    R = int(R)
    g = synthetic_graph(num_vertices=1500, avg_degree=8, num_classes=6,
                        feat_dim=24, seed=0)
    cfg = small_gnn_config(
        "graphsage", batch_size=32, feat_dim=24, num_classes=6,
        hec=HECConfig(cache_size=4096, ways=4, life_span=2, push_limit=256,
                      delay=1),
        pipeline=PipelineConfig(vectorized=name != "novec"))
    ps = partition_graph(g, R, seed=0)
    tr = DistTrainer(cfg, R, device="cpu", overlap=name != "inline")
    return name, R, ps, cfg, tr


def recorded(tr):
    """Wrap ``tr.train_step``: after every step, a copy of the HEC tags and
    ages, the queued tags, the parameters and the minibatch's layer-0
    nodes."""
    snaps, inner = [], tr.train_step

    def step(state, data, mb, seed):
        m = inner(state, data, mb, seed)
        snaps.append({
            "tags": [torch.stack([s.tags for s in layer]).clone()
                     for layer in state["hec"]],
            "age": [torch.stack([s.age for s in layer]).clone()
                    for layer in state["hec"]],
            "inflight": torch.stack([q["tags"] for q in
                                     state["inflight"]]).clone(),
            "params": [p.detach().clone()
                       for p in state["model"].parameter_list()],
            "nodes0": mb["layer_nodes"][0].clone(), "m": m})
        return m
    tr.train_step = step
    return snaps


@pytest.mark.parametrize("case", CASES)
def test_trainer_paths_match_reference(reference_run, case):
    """``train_epochs`` on the unstaged path (R=1, R=4), with the per-row
    sampler in the pipeline and with the inline push, against the
    reference's ``train_epochs`` on the same path: every step's loss,
    counters, HEC tags and ages, queued tags and parameters; the epochs'
    losses and hit rates; at R=4 unstaged, ``evaluate(pipeline=None)``."""
    ref = {k.removeprefix(f"{case}/"): v for k, v in reference_run.items()
           if k.startswith(f"{case}/")}
    name, R, ps, cfg, tr = port_setup(case)
    st = tr.init_state(seed=0)
    data = build_dist_data(ps, cfg, CPU)
    snaps = recorded(tr)
    st, hist = tr.train_epochs(ps, data, st, EPOCHS[R],
                               pipeline=None if name == "none" else "auto")
    assert len(snaps) == int(ref["steps"]) >= 3
    names = [n for layer in st["model"].layers for n in sorted(("wn", "ws",
                                                                "b"))]
    for i, s in enumerate(snaps):
        m = s["m"]
        want = float(ref[f"{i}/m/loss"])
        assert abs(m["loss"] - want) <= 1e-5 * abs(want), (i, m["loss"])
        for k in m:
            if k.startswith(("hec_hits", "hec_halos", "aep_push", "exam")):
                assert m[k] == float(ref[f"{i}/m/{k}"]), (i, k)
        for l in range(cfg.num_layers):
            assert_same(s["tags"][l].numpy(), ref[f"{i}/tags/{l}"])
            assert_same(s["age"][l].numpy(), ref[f"{i}/age/{l}"])
        assert_same(s["inflight"].numpy(), ref[f"{i}/inflight"])
        for j, p in enumerate(s["params"]):
            l, n = j // 3, names[j]
            np.testing.assert_allclose(p.numpy(), ref[f"{i}/p/{l}/{n}"],
                                       rtol=1e-4, atol=1e-4)
    assert snaps[-1]["m"]["aep_push_rows"] > 0 or R == 1
    for e, h in enumerate(hist):
        want = float(ref[f"hist/{e}/loss"])
        assert abs(h["loss"] - want) <= 1e-5 * abs(want)
        assert h.get("hec_hit_rate_l0", -1.0) == float(ref[f"hist/{e}/rate"])
        assert "t_step" in h and "t_wall" in h
    if case == "none-4":
        acc = tr.evaluate(ps, data, st, num_batches=2, pipeline=None)
        assert acc == pytest.approx(float(ref["eval"]), abs=1e-6)


def test_start_epoch_replays_the_epochs_batches():
    """``train_epochs(start_epoch=1)`` draws epoch 1's minibatches, as the
    run that trained epoch 0 first drew them; the registry counts each
    call's epochs."""
    from repro_torch import obs
    _, R, ps, cfg, tr = port_setup("none-4")
    data = build_dist_data(ps, cfg, CPU)
    snaps = recorded(tr)
    reg = obs.configure().registry
    try:
        _, hist = tr.train_epochs(ps, data, tr.init_state(seed=0), 2)
        first = [s["nodes0"] for s in snaps]
        steps0 = len(SamplingPlan(ps, cfg, 0).epoch_schedule(0))
        tr2 = DistTrainer(cfg, R, device="cpu")
        again = recorded(tr2)
        _, hist2 = tr2.train_epochs(ps, data, tr2.init_state(seed=0), 1,
                                    start_epoch=1)
        assert len(again) == len(first) - steps0 > 0
        for a, b in zip(again, first[steps0:]):
            assert torch.equal(a["nodes0"], b)
        assert len(hist2) == 1
        assert reg.value("train_epochs_total",
                         sampler_policy="uniform") == 3.0
    finally:
        obs.configure()


def test_history_times_only_while_the_registry_is_on():
    from repro_torch import obs
    _, _, ps, cfg, tr = port_setup("none-4")
    data = build_dist_data(ps, cfg, CPU)
    try:
        obs.configure(obs.ObsConfig(enabled=False))
        _, hist = tr.train_epochs(ps, data, tr.init_state(seed=0), 1)
        assert not any(k.startswith("t_") for k in hist[0])
        assert hist[0]["sampler_policy"] == "uniform"
    finally:
        obs.configure()
