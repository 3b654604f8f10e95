"""The port's device fanout draw (kernel I's plain version, the seed chain,
``DeviceSampler`` and ``SamplingPlan`` with ``device_draw``) against the
reference on the same numpy inputs.

Every output here is an integer, or a float32 key compared by its bits:
nothing is held to a tolerance.  The reference's keys come from
``repro.kernels.ref.sample_keys_ref`` and from the Pallas
``sample_keys_kernel`` in interpret mode (as ``tests/test_kernels.py``
runs it), its draws from ``draw_neighbors_device(use_kernel=True,
interpret=True)``, its seeds from ``jax.random`` live.  Kernel I itself is
held against the plain version on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` phase 7.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.gnn import PipelineConfig as JPipelineConfig
from repro.configs.gnn import SamplerConfig as JSamplerConfig
from repro.configs.gnn import small_gnn_config as j_small_config
from repro.graph import partition_graph as j_partition_graph
from repro.graph import synthetic_graph as j_synthetic_graph
from repro.kernels import ref as j_ref
from repro.kernels.sample_draw import (draw_neighbors_device,
                                       sample_keys_kernel)
from repro.pipeline import vectorized_sampler as j_vs
from repro.pipeline.prefetcher import SamplingPlan as JPlan
from repro_torch.configs.gnn import (PipelineConfig, SamplerConfig,
                                     small_gnn_config)
from repro_torch.graph import partition_graph, synthetic_graph
from repro_torch.kernels import ref, sample_draw
from repro_torch.pipeline import threefry
from repro_torch.pipeline.prefetcher import SamplingPlan
from repro_torch.pipeline.staging import EVAL_EPOCH_TAG, eval_schedule
from repro_torch.pipeline.vectorized_sampler import DeviceSampler

POLICIES = ("uniform", "labor", "cv")
t = torch.as_tensor


def bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


# ---------------------------------------------------------------------------
# the seed chain
# ---------------------------------------------------------------------------
def jax_seed(base, epoch, step, rank, layer):
    key = jax.random.key(base)
    for x in (epoch, step, rank, layer):
        key = jax.random.fold_in(key, x)
    return int(jax.random.bits(key, (), jnp.uint32))


@pytest.mark.parametrize("base", [0, 7, 123, 2 ** 31 - 1])
def test_seed_chain_matches_jax_random(base):
    epochs = [0, 1, 5, EVAL_EPOCH_TAG + 123, EVAL_EPOCH_TAG + base % 1000,
              2 ** 32 - 1]
    for epoch, step, rank, layer in itertools.product(
            epochs, (0, 3, 40), (0, 3), (0, 2)):
        assert threefry.draw_seed(base, epoch, step, rank, layer) == \
            jax_seed(base, epoch, step, rank, layer), (epoch, step, rank,
                                                       layer)


def test_seed_chain_refuses_what_jax_cannot_fold():
    with pytest.raises(ValueError, match="uint32"):
        threefry.draw_seed(0, 2 ** 32, 0, 0, 0)
    with pytest.raises(ValueError, match="uint32"):
        threefry.draw_seed(0, 0, -1, 0, 0)
    with pytest.raises(ValueError, match="base seed"):
        threefry.draw_seed(2 ** 31, 0, 0, 0, 0)


# ---------------------------------------------------------------------------
# the keys
# ---------------------------------------------------------------------------
def key_inputs(seed, n, w):
    rng = np.random.default_rng(seed)
    nbr = rng.integers(-1, 3 * n, (n, w)).astype(np.int32)
    nbr[1] = -1                                     # a row of no candidate
    nbr[2, : w // 2] = nbr[2, -1]                   # a repeated vertex
    weights = rng.choice(np.float32([1.0, 5.0, 0.37, 3e-7, 1e-6]),
                         size=(n, w)).astype(np.float32)
    return nbr, weights


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("n,w,seed", [(1537, 13, 0xDEADBEEF), (40, 1, 3),
                                      (300, 37, 2 ** 32 - 1)])
def test_keys_match_reference(policy, n, w, seed):
    nbr, weights = key_inputs(n + w, n, w)
    got = ref.sample_keys(seed, t(nbr), t(weights), policy=policy).numpy()
    wj = jnp.asarray(weights) if policy == "cv" else None
    want = j_ref.sample_keys_ref(jnp.uint32(seed), jnp.asarray(nbr), wj,
                                 policy=policy)
    pallas = sample_keys_kernel(jnp.uint32(seed), jnp.asarray(nbr), wj,
                                policy=policy, interpret=True)
    assert got.dtype == np.float32 and got.shape == (n, w)
    np.testing.assert_array_equal(bits(got), bits(want))
    np.testing.assert_array_equal(bits(got), bits(pallas))
    assert np.isinf(got[1]).all()


def test_keys_of_given_rows_are_those_rows_of_the_full_matrix():
    nbr, weights = key_inputs(1, 64, 9)
    rows = torch.tensor([3, 17, 63, 0])
    full = ref.sample_keys(5, t(nbr), policy="uniform")
    part = ref.sample_keys(5, t(nbr[rows.numpy()]), policy="uniform",
                           rows=rows)
    assert torch.equal(full[rows].view(torch.int32), part.view(torch.int32))


# ---------------------------------------------------------------------------
# the draw, over the cases of chip_smoke.py phase 7 (a)
# ---------------------------------------------------------------------------
def ragged_csr():
    """A CSR of 40 solids (and 10 halos, VID_p 40-49) with rows of degree
    0, 1, 3 (= f), 4 and up to 70, and a row listing one vertex 5 times
    (a multi-edge)."""
    rng = np.random.default_rng(11)
    deg = rng.integers(0, 12, 40)
    deg[:6] = [0, 1, 3, 4, 70, 9]
    rows = [rng.integers(0, 50, d) for d in deg]
    rows[5] = np.array([7, 44, 7, 7, 12, 7, 3, 7, 30])
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    return indptr, np.concatenate(rows).astype(np.int64), 40, 50


def draw_case(name):
    """(indptr, indices, S, n_vids, cur, allow, f, width) of one case."""
    if name.startswith("ragged"):
        indptr, indices, S, V = ragged_csr()
        rng = np.random.default_rng(5)
        cur = rng.integers(0, S, 77)               # no multiple of 32
        cur[:10] = [-1, 45, 0, 1, 2, 3, 4, 5, 49, 5]
        allow = rng.random(77) > 0.2
        allow[9] = False                           # the multi-edge row, once
        f = 3
        if name == "ragged-narrow":               # width < f: all take-all
            keep = np.diff(indptr) <= 2
            indices = np.concatenate([indices[indptr[i]:indptr[i + 1]]
                                      for i in range(S) if keep[i]])
            indptr = np.concatenate(
                [[0], np.cumsum(np.where(keep, np.diff(indptr), 0))])
            f = 4
        width = max(int(np.diff(indptr).max()), 1)
        return indptr, indices, S, V, cur, allow, f, width
    if name == "empty":
        return (np.zeros(5, np.int64), np.zeros(0, np.int64), 4, 4,
                np.array([0, 3, -1]), None, 2, 1)
    raise KeyError(name)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("case", ["ragged", "ragged-narrow", "empty"])
def test_draw_matches_reference(policy, case):
    indptr, indices, S, V, cur, allow, f, width = draw_case(case)
    wtab = np.random.default_rng(2).choice(
        np.float32([1.0, 5.0]), V).astype(np.float32)
    seed = 0x9E3779B1
    got = ref.draw_neighbors(
        t(indptr.astype(np.int32)), t(indices.astype(np.int32)), t(wtab),
        t(cur.astype(np.int32)), seed, None if allow is None else t(allow),
        f=f, num_solid=S, width=width, policy=policy)
    want = draw_neighbors_device(
        jnp.asarray(indptr.astype(np.int32)),
        jnp.asarray(indices.astype(np.int32)), jnp.asarray(wtab),
        jnp.asarray(cur.astype(np.int32)), jnp.uint32(seed),
        None if allow is None else jnp.asarray(allow), f=f, num_solid=S,
        width=width, policy=policy, use_kernel=True, interpret=True)
    assert got.dtype == torch.int32 and got.shape == (len(cur), f)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if case == "ragged":
        g = got.numpy()
        assert (g[:2] == -1).all() and (g[8] == -1).all()   # -1 and halos
        assert (g[~allow] == -1).all()
        np.testing.assert_array_equal(g[2], -1)              # deg 0
        np.testing.assert_array_equal(g[4], indices[1:4])    # deg == f
        big = g[6]                                            # deg 70 > f
        assert set(big) <= set(indices[indptr[4]:indptr[5]])


def test_draw_in_blocks_equals_one_block():
    indptr, indices, S, V, cur, allow, f, width = draw_case("ragged")
    args = (t(indptr.astype(np.int32)), t(indices.astype(np.int32)),
            torch.ones(V), t(cur.astype(np.int32)), 77, t(allow))
    for policy in POLICIES:
        one = ref.draw_neighbors(*args, f=f, num_solid=S, width=width,
                                 policy=policy)
        blocks = ref.draw_neighbors(*args, f=f, num_solid=S, width=width,
                                    policy=policy, limit=width * 3)
        assert torch.equal(one, blocks)


def test_sample_draw_wrapper_runs_the_plain_version_on_the_cpu():
    indptr, indices, S, V, cur, allow, f, width = draw_case("ragged")
    args = (t(indptr.astype(np.int32)), t(indices.astype(np.int32)),
            torch.ones(V), t(cur.astype(np.int32)), 3, t(allow))
    before = sample_draw.sample_draw.launches
    got = sample_draw.sample_draw(*args, f=f, num_solid=S, width=width,
                                  policy="labor")
    assert torch.equal(got, ref.draw_neighbors(
        *args, f=f, num_solid=S, width=width, policy="labor"))
    assert sample_draw.sample_draw.launches == before
    with pytest.raises(ValueError, match="unknown sample policy"):
        sample_draw.sample_draw(*args, f=f, num_solid=S, width=width,
                                policy="fast")
    m = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sample_draw.sample_draw(*[a.to(m) for a in args[:4]], 3, None, f=f,
                                num_solid=S, width=width)


# ---------------------------------------------------------------------------
# DeviceSampler and SamplingPlan
# ---------------------------------------------------------------------------
GRAPH = dict(num_vertices=400, avg_degree=8, num_classes=5, feat_dim=8,
             seed=4)


@pytest.fixture(scope="module")
def parts_pair():
    return (partition_graph(synthetic_graph(**GRAPH), 4, seed=1),
            j_partition_graph(j_synthetic_graph(**GRAPH), 4, seed=1))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("resident", [False, True])
def test_device_sampler_matches_reference(parts_pair, policy, resident):
    ps, jps = parts_pair
    part, jpart = ps.parts[2], jps.parts[2]
    dev = DeviceSampler(part, base_seed=9, rank=2, policy=policy,
                        device="cpu")
    jdev = j_vs.DeviceSampler(jpart, base_seed=9, rank=2, policy=policy)
    assert dev.width == jdev.width
    rng = np.random.default_rng(3)
    if resident:
        mask = rng.random(part.num_solid + part.num_halo) < 0.4
        dev.set_residency(mask)
        jdev.set_residency(mask)
    S = part.num_solid
    cur = rng.integers(-1, S + part.num_halo, 150)
    allow = rng.random(150) > 0.1
    for (epoch, step, layer), f, al in zip(
            [(0, 0, 2), (1, 3, 1), (EVAL_EPOCH_TAG + 123, 1, 0)], (3, 4, 2),
            (None, allow, None)):
        got = dev.draw(epoch, step, layer, cur, f, al)
        want = jdev.draw(epoch, step, layer, cur, f, al)
        assert got.dtype == np.int64 and got.shape == (150, f)
        np.testing.assert_array_equal(got, want)
        assert dev.seed(epoch, step, layer) == int(jdev._seed(epoch, step,
                                                              layer))


def test_device_sampler_defaults_to_the_card(parts_pair, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceSampler(parts_pair[0].parts[0])
    cfg = small_gnn_config("graphsage", pipeline=PipelineConfig(
        sampler=SamplerConfig(device_draw=True)))
    plan = SamplingPlan(parts_pair[0], cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plan.sample_host(0, 0, plan.epoch_schedule(0)[0])


def assert_same_batch(a, b):
    assert a.keys() == b.keys()
    for k in a:
        for x, y in (zip(a[k], b[k]) if isinstance(a[k], list)
                     else [(a[k], b[k])]):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_array_equal(x, y, err_msg=k)


def plans(parts_pair, policy, workers, base_seed=0):
    kw = dict(batch_size=8, feat_dim=8, num_classes=5, fanouts=(3, 4))
    ps, jps = parts_pair
    cfg = small_gnn_config("graphsage", **kw, pipeline=PipelineConfig(
        num_workers=workers, prefetch_depth=2,
        sampler=SamplerConfig(policy=policy, device_draw=True)))
    jcfg = j_small_config("graphsage", **kw, pipeline=JPipelineConfig(
        sampler=JSamplerConfig(policy=policy, device_draw=True)))
    return (SamplingPlan(ps, cfg, base_seed, device="cpu"),
            JPlan(jps, jcfg, base_seed))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("workers", [0, 3])
def test_training_minibatches_match_reference(parts_pair, policy, workers):
    """``sample_host`` with ``device_draw`` at R=4 is the reference's, bit
    for bit, through the prefetcher with 0 or 3 workers; ``cv`` with a
    residency installed from epoch 1 on."""
    plan, jplan = plans(parts_pair, policy, workers)
    for ep in range(2):
        if policy == "cv" and ep:
            rng = np.random.default_rng(ep)
            masks = [rng.random(p.num_solid + p.num_halo) < 0.5
                     for p in parts_pair[0].parts]
            plan.set_cv_residency(masks)
            jplan.set_cv_residency(masks)
        sched, jsched = plan.epoch_schedule(ep), jplan.epoch_schedule(ep)
        assert len(sched) > 1
        got = list(plan.batches(sched, ep))
        assert len(got) == len(sched)
        for step in (0, len(sched) - 1):
            assert_same_batch(got[step],
                              jplan.sample_host(ep, step, jsched[step]))


@pytest.mark.parametrize("policy", POLICIES)
def test_eval_minibatches_match_reference(parts_pair, policy):
    from repro.pipeline.staging import MinibatchPipeline
    plan, jplan = plans(parts_pair, policy, 3, base_seed=123)
    got = list(plan.batches(eval_schedule(plan, 3, 123),
                            EVAL_EPOCH_TAG + 123))
    want = list(MinibatchPipeline(jplan.ps, jplan.cfg, base_seed=123)
                .eval_batches(3, seed=123))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert_same_batch(a, {k: [np.asarray(x) for x in v]
                              if isinstance(v, list) else np.asarray(v)
                              for k, v in b.items()})


def test_device_draw_differs_from_host_draw(parts_pair):
    """The device draw is another stream than the host's ``rng``: the
    draws differ, the capacities and prefix invariant do not."""
    ps = parts_pair[0]
    kw = dict(batch_size=8, feat_dim=8, num_classes=5, fanouts=(3, 4))
    host = SamplingPlan(ps, small_gnn_config("graphsage", **kw), 0)
    dev, _ = plans(parts_pair, "uniform", 0)
    sched = host.epoch_schedule(0)
    a, b = host.sample_host(0, 0, sched[0]), dev.sample_host(0, 0, sched[0])
    assert [x.shape for x in a["layer_nodes"]] == \
        [x.shape for x in b["layer_nodes"]]
    assert not all(np.array_equal(x, y) for x, y in zip(a["nbr_idx"],
                                                        b["nbr_idx"]))
    for k in range(2):
        n_dst = b["layer_nodes"][k + 1].shape[1]
        np.testing.assert_array_equal(b["layer_nodes"][k][:, :n_dst],
                                      b["layer_nodes"][k + 1])


def test_sampler_config_validates_like_reference():
    for kw in (dict(policy="fast", device_draw=True), dict(policy="labor"),
               dict(policy="cv", device_draw=False)):
        with pytest.raises(ValueError):
            JSamplerConfig(**kw)
        with pytest.raises(ValueError):
            SamplerConfig(**kw)
    a, b = SamplerConfig(), JSamplerConfig()
    assert (a.policy, a.device_draw, a.cv_boost) == (b.policy, b.device_draw,
                                                     b.cv_boost)
    assert PipelineConfig().sampler == SamplerConfig()
