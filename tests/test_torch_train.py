"""The port's ``aep`` training slice against the reference, on the CPU.

The same numpy inputs go through ``repro`` and ``repro_torch``: Adam, the
GraphSAGE training forward and its gradients, the AEP pieces (delay queue,
push selection with the reference's uniforms, the fused push on the
stacked backend, the consume into the HEC), and the whole trainer, for
GraphSAGE and for GAT, at R=1 and R=4 for three steps, with the
reference's initial params and its selection uniforms (drawn in a
subprocess with four forced host devices, as ``tests/test_comm.py`` runs
its trainer).

Tolerances: integer and data-movement outputs are held bit for bit (HEC
tags, ages and pushed rows, push selections, minibatches); the loss
within 1e-5 relative and the parameters within rtol/atol 1e-4, since
torch and XLA sum float32 in different orders (measured here: about 1e-7
and 4e-7).
"""
import importlib.util
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

from repro.cache import hec as j_hec
from repro.comm.engine import HaloExchangeEngine as JEngine
from repro.configs.gnn import small_gnn_config as j_small_config
from repro.core import aep as j_aep
from repro.graph import partition_graph as j_partition_graph
from repro.graph import synthetic_graph as j_synthetic_graph
from repro.models.gnn import graphsage as j_sage
from repro.pipeline.vectorized_sampler import \
    sample_blocks_vectorized as j_sample
from repro.train import optimizer as j_opt
from repro_torch.cache import hec
from repro_torch.comm import HaloExchangeEngine, StackedCollective
from repro_torch.configs.gnn import (HECConfig, PipelineConfig,
                                     SamplerConfig, small_gnn_config)
from repro_torch.core import aep
from repro_torch.graph import partition_graph, synthetic_graph
from repro_torch.models.gnn.graphsage import GraphSAGE, init_params_np
from repro_torch.pipeline.prefetcher import SamplingPlan
from repro_torch.train import optimizer as opt
from repro_torch.train.gnn_trainer import (DistTrainer, build_dist_data,
                                           minibatch_to_device)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
t = torch.as_tensor


def bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


# ---------------------------------------------------------------------------
# Adam
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scale", [0.01, 10.0], ids=["clip-off", "clip-on"])
def test_adam_matches_reference(scale):
    """Within a few float32 ulps (rtol 1e-5): the clip scale and the
    bias-correction powers round at other places in torch and XLA."""
    rng = np.random.default_rng(0)
    shapes = [(5,), (4, 5), (4, 5), (3,), (5, 3), (5, 3)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    cfg = dict(lr=0.006, grad_clip=1.0)
    jp, js = [jnp.asarray(p) for p in params], None
    js = j_opt.adam_init(jp)
    tp = [t(p.copy()) for p in params]
    ts = opt.adam_init(tp)
    for step in range(3):
        grads = [(rng.normal(size=s) * scale).astype(np.float32)
                 for s in shapes]
        jp, js, jd = j_opt.adam_update([jnp.asarray(g) for g in grads], js,
                                       jp, j_opt.AdamConfig(**cfg))
        td = opt.adam_update([t(g) for g in grads], ts, tp,
                             opt.AdamConfig(**cfg))
        np.testing.assert_allclose(float(td["grad_norm"]),
                                   float(jd["grad_norm"]), rtol=1e-5)
        assert (float(jd["grad_norm"]) > 1.0) == (scale > 1.0)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-7)
        for a, b in zip(ts.mu + ts.nu, js["mu"] + js["nu"]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-9)
    assert ts.step == int(js["step"]) == 3


# ---------------------------------------------------------------------------
# the model: training forward + masked CE, value and parameter gradients
# ---------------------------------------------------------------------------
def masked_ce_jax(params, h0, valid0, blocks, seed_mask, labels, dropout):
    out, valid = j_sage.forward(params, h0, valid0, blocks, dropout=dropout,
                                seed=jnp.uint32(2 ** 32 - 1))
    B = labels.shape[0]
    logits = out[:B]
    lmask = seed_mask & valid[:B]
    logz = jax.scipy.special.logsumexp(logits, -1)
    gold = jnp.take_along_axis(logits, labels[:, None], -1)[:, 0]
    nll = (logz - gold) * lmask
    return nll.sum() / jnp.maximum(lmask.sum(), 1)


@pytest.mark.parametrize("layers,dropout", [(2, 0.1), (3, 0.5), (3, 0.0)])
def test_train_forward_and_grads_match_reference(layers, dropout):
    part = partition_graph(synthetic_graph(
        num_vertices=600, avg_degree=6, num_classes=5, feat_dim=16, seed=1),
        1).parts[0]
    fanouts = (3, 4, 5)[:layers]
    seeds = np.flatnonzero(part.train_mask)[:20]
    mb = j_sample(part, seeds, fanouts, np.random.default_rng(4), 24)
    dims = [16] + [32] * (layers - 1) + [5]
    p = init_params_np(3, dims)
    h0 = part.features[np.maximum(mb.layer_nodes[0], 0)] \
        * mb.node_mask[0][:, None]
    valid0 = mb.node_mask[0]
    jb = {"nbr_idx": [jnp.asarray(x, jnp.int32) for x in mb.nbr_idx]}
    want_loss, want_g = jax.value_and_grad(masked_ce_jax)(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(h0),
        jnp.asarray(valid0), jb, jnp.asarray(mb.seed_mask),
        jnp.asarray(mb.labels, jnp.int32), dropout)

    model = GraphSAGE(dims).params_from_jax(p)
    out, valid = model.train_forward(
        t(h0), t(valid0), {"nbr_idx": [t(x.astype(np.int32))
                                       for x in mb.nbr_idx]},
        dropout=dropout, seed=2 ** 32 - 1)
    lmask = t(mb.seed_mask) & valid[:24]
    logits = out[:24]
    nll = (torch.logsumexp(logits, -1) - logits.gather(
        1, t(mb.labels)[:, None])[:, 0]) * lmask.float()
    loss = nll.sum() / lmask.sum().clamp_min(1)
    grads = torch.autograd.grad(loss, model.parameter_list())
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    leaves = jax.tree_util.tree_leaves(want_g)       # per layer: b, wn, ws
    assert len(leaves) == len(grads)
    for a, b in zip(grads, leaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# AEP pieces
# ---------------------------------------------------------------------------
def test_queue_pop_push_matches_reference():
    rng = np.random.default_rng(0)
    q = {"tags": rng.integers(-1, 99, (2, 3, 2, 4)).astype(np.int32),
         "embs": rng.normal(size=(2, 3, 2, 4, 5)).astype(np.float32)}
    nt = rng.integers(-1, 99, (3, 2, 4)).astype(np.int32)
    ne = rng.normal(size=(3, 2, 4, 5)).astype(np.float32)
    got = aep.queue_pop_push({k: t(v) for k, v in q.items()}, t(nt), t(ne))
    want = j_aep.queue_pop_push({k: jnp.asarray(v) for k, v in q.items()},
                                jnp.asarray(nt), jnp.asarray(ne))
    for k in ("tags", "embs"):
        np.testing.assert_array_equal(bits(got[k]), bits(want[k]))
    init = aep.queue_init(2, 3, 2, 4, 5, CPU)
    j_init = j_aep.queue_init(2, 3, 2, 4, 5)
    for k in ("tags", "embs"):
        np.testing.assert_array_equal(init[k].numpy(), np.asarray(j_init[k]))


@pytest.fixture(scope="module")
def three_ranks():
    kw = dict(num_vertices=900, avg_degree=6, num_classes=5, feat_dim=8,
              seed=2)
    return (partition_graph(synthetic_graph(**kw), 3, seed=1),
            j_partition_graph(j_synthetic_graph(**kw), 3, seed=1))


@pytest.mark.parametrize("seed", [0, 5])
def test_select_push_matches_reference(three_ranks, seed):
    """The push selection from the reference's own uniforms (its fold-in
    chain on (7, seed, rank)): tags and rows bit-exact, per rank."""
    ps, jps = three_ranks
    from repro.train.gnn_trainer import build_dist_data as j_build
    cfg = small_gnn_config("graphsage", batch_size=16, feat_dim=8,
                           num_classes=5, hec=HECConfig(
                               cache_size=256, ways=4, push_limit=40))
    jcfg = j_small_config("graphsage", batch_size=16, feat_dim=8,
                          num_classes=5)
    data = build_dist_data(ps, cfg, CPU)
    jdata = j_build(jps, jcfg)
    dims, R, L = [8, 12], 3, 2
    jeng = JEngine(R, L, push_limit=40)
    eng = HaloExchangeEngine(R, L, 40, 1, StackedCollective(R))
    rng = np.random.default_rng(seed)
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
        want = jeng.select_push(
            jd, {"layer_nodes": [jnp.asarray(n) for n in nodes],
                 "node_mask": [jnp.asarray(m) for m in mb.node_mask]},
            {l: tuple(map(jnp.asarray, c)) for l, c in enumerate(captured)},
            [jnp.asarray(v) for v in vid_nodes], jd["num_solid"],
            jnp.uint32(seed), dims, 12, jnp.int32(r))
        key = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(7), jnp.uint32(seed)), jnp.int32(r))
        u = jax.random.uniform(key, (R, len(nodes[0])), minval=1e-6,
                               maxval=1.0)
        got = eng.select_push(
            data["push_mask"][r], t(nodes[0]), t(mb.node_mask[0]),
            t(vid_nodes[0]), data["num_solid"][r],
            [tuple(map(t, c)) for c in captured], t(np.array(u)), dims, 12)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(bits(a), bits(b))
        assert (got[0] >= 0).any()                 # something was selected


def test_fused_push_round_trip_on_stacked_backend():
    rng = np.random.default_rng(1)
    R, L, nc, d = 3, 2, 5, 4
    tags = rng.integers(-1, 2 ** 30, (R, R, L, nc)).astype(np.int32)
    tags[0, 1, 0, :2] = [-1, 2 ** 30 - 1]
    embs = rng.normal(size=(R, R, L, nc, d)).astype(np.float32)
    embs.view(np.int32)[1, 2, 1, 0, :2] = [0x7FC00001, -1]   # NaN payloads
    eng = HaloExchangeEngine(R, L, nc, 1, StackedCollective(R))
    rt, re = eng.push(t(tags), t(embs))
    np.testing.assert_array_equal(rt.numpy(), tags.transpose(1, 0, 2, 3))
    np.testing.assert_array_equal(
        re.numpy().view(np.int32),
        embs.transpose(1, 0, 2, 3, 4).view(np.int32))
    q = eng.inflight_init(d, CPU)
    out, stats = eng.aep_push([(t(tags[r]), t(embs[r])) for r in range(R)],
                              q, [d, 3])
    for r in range(R):
        np.testing.assert_array_equal(out[r]["tags"][-1].numpy(), tags[:, r])
    np.testing.assert_array_equal(stats["push_rows"].numpy(),
                                  (tags >= 0).sum(axis=(1, 2, 3)))


def test_psum_and_all_to_all_shapes():
    c = StackedCollective(3)
    x = torch.arange(24.0).reshape(3, 2, 4)
    assert torch.equal(c.psum(x), x[0] + x[1] + x[2])
    with pytest.raises(ValueError):
        c.all_to_all(x)


def test_consume_push_matches_reference():
    """tick + store of the delay-expired slot: tags, ages and values
    bit-exact, from a partly filled state with same-set overflow."""
    rng = np.random.default_rng(3)
    R, L, nc, dims, ls = 3, 2, 24, [6, 4], 1
    jst = [j_hec.hec_init(64, 4, d) for d in dims]
    for l, d in enumerate(dims):
        for _ in range(3):
            v = rng.integers(-1, 300, 40).astype(np.int32)
            jst[l] = j_hec.hec_store(jst[l], jnp.asarray(v), jnp.asarray(
                rng.normal(size=(40, d)).astype(np.float32)))
        jst[l] = j_hec.hec_tick(jst[l], 5)
    q = {"tags": rng.integers(-1, 300, (1, R, L, nc)).astype(np.int32),
         "embs": rng.normal(size=(1, R, L, nc, 6)).astype(np.float32)}
    st = [hec.HECState(tags=t(np.array(s.tags)), age=t(np.array(s.age)),
                       values=t(np.array(s.values))) for s in jst]
    want = JEngine(R, L, push_limit=nc).consume_push(
        jst, {k: jnp.asarray(v) for k, v in q.items()}, dims, ls)
    HaloExchangeEngine(R, L, nc, 1, StackedCollective(R)).consume_push(
        st, {k: t(v) for k, v in q.items()}, dims, ls)
    for a, b in zip(st, want):
        for f in ("tags", "age", "values"):
            np.testing.assert_array_equal(bits(getattr(a, f)),
                                          bits(getattr(b, f)))


# ---------------------------------------------------------------------------
# the slices as a whole: 3 steps at R=1 and R=4 against the reference
# ---------------------------------------------------------------------------
STEPS = 3
MODELS = ("graphsage", "gat")
PARAM_NAMES = {"graphsage": ("wn", "ws", "b"),
               "gat": ("w", "b", "a_u", "a_v")}
_REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh
from repro.configs.gnn import HECConfig, small_gnn_config
from repro.graph import partition_graph, synthetic_graph
from repro.pipeline.staging import MinibatchPipeline
from repro.train.gnn_trainer import DistTrainer, build_dist_data

STEPS = int(sys.argv[2])
out = {}
g = synthetic_graph(num_vertices=1500, avg_degree=8, num_classes=6,
                    feat_dim=24, seed=0)
for model, R in [(m, R) for m in sys.argv[3].split(",") for R in (1, 4)]:
    cfg = small_gnn_config(model, batch_size=32, feat_dim=24, num_classes=6,
                           hec=HECConfig(cache_size=4096, ways=4,
                                         life_span=2, push_limit=256,
                                         delay=1))
    ps = partition_graph(g, R, seed=0)
    dd = build_dist_data(ps, cfg)
    mesh = Mesh(np.array(jax.devices()[:R]), ("data",))
    tr = DistTrainer(cfg=cfg, mesh=mesh, num_ranks=R, mode="aep")
    st = tr.init_state(jax.random.key(0), dd)
    pre = f"{model}/r{R}"
    for l, layer in enumerate(st["params"]["layers"]):
        for n, v in layer.items():
            out[f"{pre}/params0/{l}/{n}"] = np.asarray(v)
    step_fn = tr.make_step(dd, donate=False)
    pipe = MinibatchPipeline(ps, cfg, base_seed=0, mesh=mesh)
    def batches():
        ep = 0
        while True:
            yield from pipe.epoch_batches(ep)
            ep += 1
    for i, mb in zip(range(STEPS), batches()):
        seed = jnp.uint32(i)
        N0 = mb["layer_nodes"][0].shape[1]
        key = jax.random.fold_in(jax.random.PRNGKey(7), seed)
        out[f"{pre}/u/{i}"] = np.stack([np.asarray(jax.random.uniform(
            jax.random.fold_in(key, jnp.int32(r)), (R, N0), minval=1e-6,
            maxval=1.0)) for r in range(R)])
        (st["params"], st["opt_state"], st["hec"], st["hot"],
         st["inflight"], _, metrics) = step_fn(
            st["params"], st["opt_state"], st["hec"], st["hot"],
            st["inflight"], dd, mb, seed)
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
        out[f"{pre}/inflight/{i}"] = np.asarray(st["inflight"]["tags"])
    st["step"] = jnp.asarray(STEPS, jnp.int32)
    out[f"{pre}/eval_acc"] = np.asarray(tr.evaluate(ps, dd, st,
                                                    num_batches=2))

# the device draw under cv: two epochs of train_epochs at R=4, per-step
# metrics through a wrapped step function
import dataclasses
from repro.configs.gnn import PipelineConfig, SamplerConfig
from repro.graph.sampling import layer_capacities
R, pre = 4, "cv"
cfg = small_gnn_config("graphsage", batch_size=32, feat_dim=24,
                       num_classes=6,
                       hec=HECConfig(cache_size=4096, ways=4, life_span=2,
                                     push_limit=256, delay=1),
                       pipeline=PipelineConfig(sampler=SamplerConfig(
                           policy="cv", device_draw=True)))
ps = partition_graph(g, R, seed=0)
dd = build_dist_data(ps, cfg)
mesh = Mesh(np.array(jax.devices()[:R]), ("data",))
tr = DistTrainer(cfg=cfg, mesh=mesh, num_ranks=R, mode="aep")
st = tr.init_state(jax.random.key(0), dd)
for l, layer in enumerate(st["params"]["layers"]):
    for n, v in layer.items():
        out[f"{pre}/params0/{l}/{n}"] = np.asarray(v)
N0 = layer_capacities(cfg.batch_size, cfg.fanouts)[0]
inner = tr.make_step(dd, donate=False)
log = []
def step_fn(*a):
    res = inner(*a)
    i = len(log)
    log.append({k: np.asarray(v) for k, v in res[-1].items()})
    for k, v in log[-1].items():
        out[f"{pre}/m/{i}/{k}"] = v
    return res
for i in range(8):
    key = jax.random.fold_in(jax.random.PRNGKey(7), jnp.uint32(i))
    out[f"{pre}/u/{i}"] = np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(key, jnp.int32(r)), (R, N0), minval=1e-6,
        maxval=1.0)) for r in range(R)])
st, hist = tr.train_epochs(ps, dd, st, 2, step_fn=step_fn)
out[f"{pre}/steps"] = np.asarray(len(log))
for e, h in enumerate(hist):
    out[f"{pre}/hist/{e}/loss"] = np.asarray(h["loss"])
    out[f"{pre}/hist/{e}/policy"] = np.asarray(h["sampler_policy"])
for l, layer in enumerate(st["params"]["layers"]):
    for n, v in layer.items():
        out[f"{pre}/params/{l}/{n}"] = np.asarray(v)
for l, h in enumerate(st["hec"]):
    for f in ("tags", "age", "values"):
        out[f"{pre}/{f}/{l}"] = np.asarray(getattr(h, f))
out[f"{pre}/inflight"] = np.asarray(st["inflight"]["tags"])
out[f"{pre}/eval_acc"] = np.asarray(tr.evaluate(ps, dd, st, num_batches=2))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", _REF_SCRIPT, str(path),
                           str(STEPS), ",".join(MODELS)], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


def trainer_setup(model, R, ref):
    g = synthetic_graph(num_vertices=1500, avg_degree=8, num_classes=6,
                        feat_dim=24, seed=0)
    cfg = small_gnn_config(model, batch_size=32, feat_dim=24,
                           num_classes=6,
                           hec=HECConfig(cache_size=4096, ways=4,
                                         life_span=2, push_limit=256,
                                         delay=1))
    ps = partition_graph(g, R, seed=0)
    pre = f"{model}/r{R}"
    tr = DistTrainer(cfg, R, device="cpu", push_uniforms=lambda s, r, sh:
                     t(ref[f"{pre}/u/{s}"][r]))
    params = {"layers": [{n: ref[f"{pre}/params0/{l}/{n}"]
                          for n in PARAM_NAMES[model]} for l in range(2)]}
    return ps, cfg, tr, tr.init_state(params=params), \
        build_dist_data(ps, cfg, CPU)


def stacked(state, field, l):
    return torch.stack([getattr(s, field) for s in state["hec"][l]]).numpy()


def load_reference_step(st, ref, model, i):
    """Set the port's parameters and Adam moments to the reference's after
    its step ``i``."""
    with torch.no_grad():
        k = 0
        for l, layer in enumerate(st["model"].layers):
            for n in sorted(PARAM_NAMES[model]):      # the leaf order
                getattr(layer, n).copy_(t(ref[f"params/{i}/{l}/{n}"]))
                st["opt"].mu[k].copy_(t(ref[f"mu/{i}/{l}/{n}"]))
                st["opt"].nu[k].copy_(t(ref[f"nu/{i}/{l}/{n}"]))
                k += 1


def check_adam_step(st, ref, model, i, lr):
    """GAT's parameters after step ``i``, each step started from the
    reference's state.  Adam's first moment (the gradient), per leaf:
    within 1e-4 of the reference's in norm, and per entry within rtol
    1e-4 plus an atol of 1e-4 times the leaf's largest entry.  The
    parameters are within 1e-4 wherever Adam's step is set by the
    gradient.  Adam divides each entry's moment by its own root mean
    square plus eps = 1e-8, so an entry whose gradient is at float-noise
    level (the last layer's ``a_v`` has entries of 1e-10 here in both
    frameworks: its softmax is invariant to ``e_v`` but for the
    LeakyReLU's kink) moves by up to lr with either sign; those entries
    (sqrt of the bias-corrected second moment below 1e-6, 100 x eps) are
    held within 2.01 lr, the most two of Adam's first three steps from one
    start can differ (each is at most 1.004 lr), and must stay under 1% of
    all entries."""
    bias2 = 1 - 0.999 ** (i + 1)
    k, loose, total = 0, 0, 0
    for l, layer in enumerate(st["model"].layers):
        for n in sorted(PARAM_NAMES[model]):
            mu, want = st["opt"].mu[k].numpy(), ref[f"mu/{i}/{l}/{n}"]
            scale = np.linalg.norm(want)
            assert np.linalg.norm(mu - want) <= 1e-4 * scale, (i, l, n)
            np.testing.assert_allclose(mu, want, rtol=1e-4,
                                       atol=1e-4 * np.abs(want).max())
            p = getattr(layer, n).detach().numpy()
            p_want = ref[f"params/{i}/{l}/{n}"]
            sure = np.sqrt(ref[f"nu/{i}/{l}/{n}"] / bias2) > 1e-6
            np.testing.assert_allclose(p[sure], p_want[sure], rtol=1e-4,
                                       atol=1e-4)
            np.testing.assert_allclose(p[~sure], p_want[~sure], rtol=0,
                                       atol=2.01 * lr)
            loose += int((~sure).sum())
            total += sure.size
            k += 1
    assert loose <= 0.01 * total, (i, loose, total)


@pytest.mark.parametrize("model,R", [(m, R) for m in MODELS for R in (1, 4)],
                         ids=["1", "4", "gat-1", "gat-4"])
def test_three_steps_match_reference(reference_run, model, R):
    """GraphSAGE runs free for three steps.  GAT runs its first step free
    and starts each later one from the reference's parameters and Adam
    moments (``check_adam_step`` says why); its HEC and pushes run free."""
    ref = {k.removeprefix(f"{model}/"): v for k, v in reference_run.items()
           if k.startswith(f"{model}/")}
    ps, cfg, tr, st, data = trainer_setup(model, R, reference_run)
    plan = SamplingPlan(ps, cfg, 0)
    hosts = [h for ep in range(2)
             for h in plan.batches(plan.epoch_schedule(ep), ep)][:STEPS]
    rr = {k.removeprefix(f"r{R}/"): v for k, v in ref.items()
          if k.startswith(f"r{R}/")}
    for i, host in enumerate(hosts):
        if model == "gat" and i:
            load_reference_step(st, rr, model, i - 1)
        m = tr.train_step(st, data, minibatch_to_device(host, CPU), i)
        want = float(ref[f"r{R}/m/{i}/loss"])
        assert abs(m["loss"] - want) <= 1e-5 * abs(want), (i, m["loss"])
        for k in m:
            if k.startswith(("hec_hits", "hec_halos", "aep_push", "exam")):
                assert m[k] == float(ref[f"r{R}/m/{i}/{k}"]), (i, k)
        if model == "gat":
            check_adam_step(st, rr, model, i, cfg.lr)
        else:
            for l, layer in enumerate(st["model"].layers):
                for n in PARAM_NAMES[model]:
                    np.testing.assert_allclose(
                        getattr(layer, n).detach().numpy(),
                        ref[f"r{R}/params/{i}/{l}/{n}"], rtol=1e-4,
                        atol=1e-4)
        for l in range(cfg.num_layers):
            np.testing.assert_array_equal(stacked(st, "tags", l),
                                          ref[f"r{R}/tags/{i}/{l}"])
            np.testing.assert_array_equal(stacked(st, "age", l),
                                          ref[f"r{R}/age/{i}/{l}"])
            np.testing.assert_allclose(stacked(st, "values", l),
                                       ref[f"r{R}/values/{i}/{l}"],
                                       rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(
            torch.stack([q["tags"] for q in st["inflight"]]).numpy(),
            ref[f"r{R}/inflight/{i}"])
    if R == 4:
        assert m["hec_hits_l0"] > 0 and m["aep_push_rows"] > 0

    # evaluate: the reference's accuracy, and the training state untouched
    if model == "gat":
        load_reference_step(st, rr, model, STEPS - 1)
    before = {"tags": [stacked(st, "tags", l) for l in range(2)],
              "values": [stacked(st, "values", l) for l in range(2)],
              "age": [stacked(st, "age", l) for l in range(2)],
              "inflight": [q["embs"].clone() for q in st["inflight"]],
              "params": [p.detach().clone()
                         for p in st["model"].parameter_list()]}
    acc = tr.evaluate(ps, data, st, num_batches=2)
    assert acc == pytest.approx(float(ref[f"r{R}/eval_acc"]), abs=1e-6)
    for f in ("tags", "values", "age"):
        for l in range(2):
            np.testing.assert_array_equal(bits(stacked(st, f, l)),
                                          bits(before[f][l]))
    for a, b in zip(st["inflight"], before["inflight"]):
        assert torch.equal(a["embs"], b)
    for a, b in zip(st["model"].parameter_list(), before["params"]):
        assert torch.equal(a.detach(), b)


@pytest.mark.parametrize("R", [1, 4])
def test_three_steps_match_reference_injecting_nothing(reference_run, R):
    """The trainer as the launcher builds it: the initial weights from
    ``init_state(seed=0)`` and the push selection's default uniforms, no
    draw of the reference's handed in.  The weights equal the reference's
    from ``jax.random.key(0)`` bit for bit; then three free GraphSAGE
    steps hold the loss within 1e-5 and the hits, halos, pushes, HEC tags,
    ages and in-flight tags exactly, as ``test_three_steps_match_reference``
    does."""
    pre = f"graphsage/r{R}"
    g = synthetic_graph(num_vertices=1500, avg_degree=8, num_classes=6,
                        feat_dim=24, seed=0)
    cfg = small_gnn_config("graphsage", batch_size=32, feat_dim=24,
                           num_classes=6,
                           hec=HECConfig(cache_size=4096, ways=4,
                                         life_span=2, push_limit=256,
                                         delay=1))
    ps = partition_graph(g, R, seed=0)
    tr = DistTrainer(cfg, R, device="cpu")
    st = tr.init_state(seed=0)
    data = build_dist_data(ps, cfg, CPU)
    for l, layer in enumerate(st["model"].layers):
        for n in PARAM_NAMES["graphsage"]:
            np.testing.assert_array_equal(
                bits(getattr(layer, n).detach().numpy()),
                bits(reference_run[f"{pre}/params0/{l}/{n}"]))
    plan = SamplingPlan(ps, cfg, 0)
    hosts = [h for ep in range(2)
             for h in plan.batches(plan.epoch_schedule(ep), ep)][:STEPS]
    for i, host in enumerate(hosts):
        m = tr.train_step(st, data, minibatch_to_device(host, CPU), i)
        want = float(reference_run[f"{pre}/m/{i}/loss"])
        assert abs(m["loss"] - want) <= 1e-5 * abs(want), (i, m["loss"])
        for k in m:
            if k.startswith(("hec_hits", "hec_halos", "aep_push", "exam")):
                assert m[k] == float(reference_run[f"{pre}/m/{i}/{k}"]), \
                    (i, k)
        for l in range(cfg.num_layers):
            for f in ("tags", "age"):
                np.testing.assert_array_equal(
                    stacked(st, f, l), reference_run[f"{pre}/{f}/{i}/{l}"])
            np.testing.assert_allclose(stacked(st, "values", l),
                                       reference_run[f"{pre}/values/{i}/{l}"],
                                       rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(
            torch.stack([q["tags"] for q in st["inflight"]]).numpy(),
            reference_run[f"{pre}/inflight/{i}"])
    if R == 4:
        assert m["hec_hits_l0"] > 0 and m["aep_push_rows"] > 0


def test_device_draw_cv_two_epochs_match_reference(reference_run):
    """``train_epochs`` with ``device_draw=True, policy="cv"`` at R=4 for
    two epochs of two steps: epoch 1 draws with weights from the HEC as
    epoch 0 left it.  Per step the loss within 1e-5 and the hits, halos,
    pushes and examples exactly; at the end the parameters within 1e-4,
    the HEC tags, ages and in-flight tags exactly, as in
    ``test_three_steps_match_reference``; then ``evaluate``."""
    ref = {k.removeprefix("cv/"): v for k, v in reference_run.items()
           if k.startswith("cv/")}
    g = synthetic_graph(num_vertices=1500, avg_degree=8, num_classes=6,
                        feat_dim=24, seed=0)
    cfg = small_gnn_config(
        "graphsage", batch_size=32, feat_dim=24, num_classes=6,
        hec=HECConfig(cache_size=4096, ways=4, life_span=2, push_limit=256,
                      delay=1),
        pipeline=PipelineConfig(sampler=SamplerConfig(policy="cv",
                                                      device_draw=True)))
    ps = partition_graph(g, 4, seed=0)
    tr = DistTrainer(cfg, 4, device="cpu", push_uniforms=lambda s, r, sh:
                     t(ref[f"u/{s}"][r]))
    st = tr.init_state(params={"layers": [
        {n: ref[f"params0/{l}/{n}"] for n in PARAM_NAMES["graphsage"]}
        for l in range(2)]})
    data = build_dist_data(ps, cfg, CPU)
    st, hist = tr.train_epochs(ps, data, st, 2)
    log = tr.step_log
    assert len(log) == int(ref["steps"]) == 4
    assert [h["sampler_policy"] for h in hist] == ["cv", "cv"] == \
        [str(ref[f"hist/{e}/policy"]) for e in range(2)]
    for i, m in enumerate(log):
        want = float(ref[f"m/{i}/loss"])
        assert abs(m["loss"] - want) <= 1e-5 * abs(want), (i, m["loss"])
        for k in m:
            if k.startswith(("hec_hits", "hec_halos", "aep_push", "exam")):
                assert m[k] == float(ref[f"m/{i}/{k}"]), (i, k)
    for e, h in enumerate(hist):
        want = float(ref[f"hist/{e}/loss"])
        assert abs(h["loss"] - want) <= 1e-5 * abs(want)
    assert sum(m["hec_hits_l0"] for m in log[2:]) > 0
    for l, layer in enumerate(st["model"].layers):
        for n in PARAM_NAMES["graphsage"]:
            np.testing.assert_allclose(getattr(layer, n).detach().numpy(),
                                       ref[f"params/{l}/{n}"], rtol=1e-4,
                                       atol=1e-4)
    for l in range(cfg.num_layers):
        np.testing.assert_array_equal(stacked(st, "tags", l),
                                      ref[f"tags/{l}"])
        np.testing.assert_array_equal(stacked(st, "age", l), ref[f"age/{l}"])
        np.testing.assert_allclose(stacked(st, "values", l),
                                   ref[f"values/{l}"], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(
        torch.stack([q["tags"] for q in st["inflight"]]).numpy(),
        ref["inflight"])
    acc = tr.evaluate(ps, data, st, num_batches=2)
    assert acc == pytest.approx(float(ref["eval_acc"]), abs=1e-6)
    # the residency moves the draw: epoch 1's first minibatch with the
    # weights the trained HEC gives against the same with none resident
    plan = SamplingPlan(ps, cfg, 0, device="cpu")
    seeds = plan.epoch_schedule(1)[0]
    flat = plan.sample_host(1, 0, seeds)
    plan.set_cv_residency(tr._cv_residency(ps, st))
    assert any(m.any() for m in tr._cv_residency(ps, st))
    boosted = plan.sample_host(1, 0, seeds)
    assert not all(np.array_equal(a, b) for a, b in zip(flat["nbr_idx"],
                                                        boosted["nbr_idx"]))


# ---------------------------------------------------------------------------
# launcher, slice boundaries, device rule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model", MODELS)
def test_float64_witness_matches_first_step(model):
    """``chip_smoke.py``'s float64 witness of the first step (Adam's first
    moment, through the trainer's own per-rank forward) equals the
    trainer's float32 step within 1e-5 relative per tensor."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    g = synthetic_graph(num_vertices=1500, avg_degree=8, num_classes=6,
                        feat_dim=24, seed=0)
    cfg = small_gnn_config(model, batch_size=32, feat_dim=24, num_classes=6,
                           hec=HECConfig(cache_size=4096, ways=4,
                                         push_limit=256))
    ps = partition_graph(g, 4, seed=0)
    plan = SamplingPlan(ps, cfg, 0)
    host = plan.sample_host(0, 0, plan.epoch_schedule(0)[0])
    tr = DistTrainer(cfg, 4, device="cpu")
    st = tr.init_state(seed=0)
    tr.train_step(st, build_dist_data(ps, cfg, CPU),
                  minibatch_to_device(host, CPU), 0)
    want = smoke.float64_first_moment(torch, ps, cfg, 4, host)
    for got, w in zip(st["opt"].mu, want):
        assert w.dtype == torch.float64
        assert smoke.rel_norm(got.double(), w) <= 1e-5


@pytest.mark.parametrize("mode", ["aep", "sync", "drop"])
def test_launcher_trains_on_cpu(tmp_path, capsys, mode):
    from repro_torch.launch import train
    ckpt = str(tmp_path / "params.npz")
    res = train.run_gnn(train.parse_args(
        ["gnn", "--device", "cpu", "--ranks", "2", "--vertices", "1200",
         "--epochs", "2", "--batch", "32", "--ckpt", ckpt, "--mode", mode]))
    out = capsys.readouterr().out
    assert "graph: V=1200" in out and "partitioned into 2" in out
    assert out.count(f"[{mode}] epoch") == 2 and "test_acc=" in out
    assert res["trainer"].mode == mode
    hist = res["history"]
    # outside aep nothing is pushed and layer 0 alone counts halos
    assert ("aep_push_rows" in hist[0]) == (mode == "aep")
    assert ("hec_hits_l1" in hist[0]) == (mode == "aep")
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert {"t_sample", "t_host_prep", "t_stage", "t_step"} <= set(hist[0])
    with np.load(ckpt) as z:
        leaves = [z[f"leaf_{i}"] for i in range(6)]
        assert int(z["__step__"]) == res["state"]["step"]
    for a, b in zip(leaves, res["state"]["model"].parameter_list()):
        np.testing.assert_array_equal(a, b.detach().numpy())


def test_launcher_trains_gat_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train
    ckpt = str(tmp_path / "params.npz")
    res = train.run_gnn(train.parse_args(
        ["gnn", "--model", "gat", "--device", "cpu", "--ranks", "2",
         "--vertices", "1200", "--epochs", "2", "--batch", "32", "--hidden",
         "16", "--lr", "0.003", "--ckpt", ckpt]))
    out = capsys.readouterr().out
    assert out.count("[aep] epoch") == 2 and "test_acc=" in out
    hist = res["history"]
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert all(np.isfinite(h["loss"]) for h in hist)
    model = res["state"]["model"]
    assert [layer.w.shape[1:] for layer in model.layers] == [(4, 16),
                                                             (1, 16)]
    assert res["state"]["hec"][1][0].values.shape[-1] == 64   # 16 x 4 heads
    with np.load(ckpt) as z:
        assert sorted(z.files) == sorted(
            [f"leaf_{i}" for i in range(8)] + ["__step__"])
        leaves = [z[f"leaf_{i}"] for i in range(8)]
    for a, b in zip(leaves, model.parameter_list()):
        np.testing.assert_array_equal(a, b.detach().numpy())
    assert leaves[0].shape == (4, 16) and leaves[3].shape == (64, 4, 16)


def test_constructors_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = small_gnn_config("graphsage")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GraphSAGE.from_config(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hec.EmbeddingCache([4, 3], 100)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistTrainer(cfg, 2)
    assert GraphSAGE.from_config(cfg, device="cpu").layers[0].wn.device == CPU
    assert hec.EmbeddingCache([4, 3], 100, device="cpu").device == CPU


def test_port_configs_match_reference_defaults():
    from repro.configs import gnn as j_cfg
    from repro_torch.configs import gnn as t_cfg
    a, b = t_cfg.HECConfig(), j_cfg.HECConfig()
    assert json.dumps([a.cache_size, a.ways, a.life_span, a.push_limit,
                       a.delay, a.hot_size, a.hot_budget]) == json.dumps(
        [b.cache_size, b.ways, b.life_span, b.push_limit, b.delay,
         b.hot_size, b.hot_budget])
    a, b = (c.HECConfig(hot_size=48, hot_budget=32) for c in (t_cfg, j_cfg))
    assert (a.hot_size, a.hot_budget) == (b.hot_size, b.hot_budget)
    for bad in (dict(hot_size=8), dict(hot_budget=8)):
        with pytest.raises(AssertionError, match="together"):
            j_cfg.HECConfig(**bad)
        with pytest.raises(ValueError, match="together"):
            t_cfg.HECConfig(**bad)
    p, q = t_cfg.PipelineConfig(), j_cfg.PipelineConfig()
    assert (p.num_workers, p.prefetch_depth) == (q.num_workers,
                                                 q.prefetch_depth)
    assert (p.enabled, p.double_buffer, p.vectorized) == \
        (q.enabled, q.double_buffer, q.vectorized) == (True, True, True)
    for bad in (dict(num_workers=-1), dict(prefetch_depth=0)):
        for c in (t_cfg, j_cfg):
            with pytest.raises(ValueError):
                c.PipelineConfig(**bad)
    assert (p.sampler.policy, p.sampler.device_draw, p.sampler.cv_boost) \
        == (q.sampler.policy, q.sampler.device_draw, q.sampler.cv_boost)
    for policy in ("uniform", "labor", "cv"):
        a, b = (c.SamplerConfig(policy=policy, device_draw=True)
                for c in (t_cfg, j_cfg))
        assert (a.policy, a.device_draw, a.cv_boost) == \
            (b.policy, b.device_draw, b.cv_boost)
    s, r = t_cfg.small_gnn_config(), j_cfg.small_gnn_config()
    assert (s.hec.cache_size, s.hec.ways, s.hec.push_limit, s.dropout,
            s.lr) == (r.hec.cache_size, r.hec.ways, r.hec.push_limit,
                      r.dropout, r.lr)
    fields = ("name", "model", "fanouts", "hidden_size", "num_hidden_layers",
              "num_heads", "batch_size", "lr", "dropout", "aggregator",
              "feat_dim", "num_classes")
    for a, b in ((t_cfg.GRAPHSAGE_PAPERS100M, j_cfg.GRAPHSAGE_PAPERS100M),
                 (t_cfg.GAT_PAPERS100M, j_cfg.GAT_PAPERS100M),
                 (t_cfg.small_gnn_config("gat"),
                  j_cfg.small_gnn_config("gat"))):
        assert [getattr(a, f) for f in fields] == \
            [getattr(b, f) for f in fields]
