"""The port's numpy host modules reproduce the reference bit for bit: the
same seed gives the same synthetic graph, partition, sampled blocks,
full neighbor matrix and pre-warm selections in ``repro`` and
``repro_torch``."""
import numpy as np
import pytest

from repro.graph import partition_graph as j_partition_graph
from repro.graph import synthetic_graph as j_synthetic_graph
from repro.graph.sampling import layer_capacities as j_layer_capacities
from repro.pipeline.vectorized_sampler import \
    sample_blocks_vectorized as j_sample
from repro.serve.gnn import offline as j_offline
from repro.serve.gnn.prewarm import \
    select_prewarm_vids as j_select_prewarm_vids
from repro_torch.graph import layer_capacities, partition_graph, \
    synthetic_graph
from repro_torch.pipeline.vectorized_sampler import sample_blocks_vectorized
from repro_torch.serve.gnn import offline
from repro_torch.serve.gnn.prewarm import select_prewarm_vids


def assert_same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


GRAPH_FIELDS = ("indptr", "indices", "features", "labels", "train_mask",
                "test_mask")
PART_FIELDS = ("solid_vids", "halo_vids", "halo_owner", "indptr", "indices",
               "features", "labels", "train_mask", "test_mask")


@pytest.mark.parametrize("kw", [
    dict(num_vertices=600, avg_degree=4, num_classes=5, feat_dim=8, seed=0),
    dict(num_vertices=900, avg_degree=2, num_classes=7, feat_dim=16, seed=3),
])
def test_synthetic_graph_identical(kw):
    a, b = synthetic_graph(**kw), j_synthetic_graph(**kw)
    for f in GRAPH_FIELDS:
        assert_same(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("nparts", [1, 3])
def test_partition_identical(nparts):
    kw = dict(num_vertices=500, avg_degree=4, num_classes=4, feat_dim=8,
              seed=1)
    ps, jps = (partition_graph(synthetic_graph(**kw), nparts, seed=2),
               j_partition_graph(j_synthetic_graph(**kw), nparts, seed=2))
    assert_same(ps.owner, jps.owner)
    assert_same(ps.local_index, jps.local_index)
    assert ps.edge_cut_frac == jps.edge_cut_frac
    for p, q in zip(ps.parts, jps.parts):
        assert p.part_id == q.part_id
        for f in PART_FIELDS:
            assert_same(getattr(p, f), getattr(q, f))


@pytest.fixture(scope="module")
def part_pair():
    kw = dict(num_vertices=800, avg_degree=6, num_classes=5, feat_dim=8,
              seed=4)
    return (partition_graph(synthetic_graph(**kw), 1).parts[0],
            j_partition_graph(j_synthetic_graph(**kw), 1).parts[0])


@pytest.mark.parametrize("fanouts,batch", [((5, 10), 16), ((3, 4, 5), 8),
                                           ((2,), 32)])
@pytest.mark.parametrize("with_leaves", [False, True])
def test_sampled_blocks_identical(part_pair, fanouts, batch, with_leaves):
    part, jpart = part_pair
    assert layer_capacities(batch, fanouts) == \
        j_layer_capacities(batch, fanouts)
    mask_rng = np.random.default_rng(9)
    for mb in range(3):
        seeds = np.random.default_rng(mb).choice(part.num_solid, batch - mb,
                                                 replace=False)
        expandable = None
        if with_leaves:      # cache-resident vertices become leaves
            expandable = [None] + [mask_rng.random(part.num_solid) < 0.7
                                   for _ in fanouts]
        a = sample_blocks_vectorized(part, seeds, fanouts,
                                     np.random.default_rng([7, mb]), batch,
                                     expandable=expandable)
        b = j_sample(jpart, seeds, fanouts, np.random.default_rng([7, mb]),
                     batch, expandable=expandable)
        for f in ("layer_nodes", "node_mask", "nbr_idx"):
            for x, y in zip(getattr(a, f), getattr(b, f)):
                assert_same(x, y)
        for f in ("seeds", "seed_mask", "labels"):
            assert_same(getattr(a, f), getattr(b, f))


def test_full_neighbor_matrix_identical(part_pair):
    part, jpart = part_pair
    assert_same(offline.full_neighbor_matrix(part),
                j_offline.full_neighbor_matrix(jpart))
    w = int(np.diff(part.indptr).max()) + 3
    assert_same(offline.full_neighbor_matrix(part, width=w),
                j_offline.full_neighbor_matrix(jpart, width=w))


def test_prewarm_policies_identical(part_pair):
    part, jpart = part_pair
    for frac in (None, 0.1):
        assert_same(select_prewarm_vids([part], "degree", frac),
                    j_select_prewarm_vids([jpart], "degree", frac))
    log = np.random.default_rng(0).integers(0, part.num_solid, 300)
    assert_same(select_prewarm_vids([part], "query_log",
                                            query_log=log),
                j_select_prewarm_vids([jpart], "query_log",
                                              query_log=log))
    with pytest.raises(ValueError):
        select_prewarm_vids([part], "query_log")


# ---------------------------------------------------------------------------
# the training minibatch stream and the per-rank tables
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def parts_pair():
    kw = dict(num_vertices=1200, avg_degree=6, num_classes=5, feat_dim=8,
              seed=6)
    return (partition_graph(synthetic_graph(**kw), 3, seed=2),
            j_partition_graph(j_synthetic_graph(**kw), 3, seed=2))


def assert_same_batch(a, b):
    assert a.keys() == b.keys()
    for k in a:
        for x, y in (zip(a[k], b[k]) if isinstance(a[k], list)
                     else [(a[k], b[k])]):
            assert_same(x, y)


@pytest.mark.parametrize("base_seed", [0, 11])
def test_training_minibatches_identical(parts_pair, base_seed):
    """``SamplingPlan``'s schedules and ``stack_ranks``' [R, ...] batches
    are the reference's, bit for bit (so both trainers see one stream)."""
    from repro.configs.gnn import small_gnn_config as j_cfg
    from repro.pipeline.prefetcher import SamplingPlan as JPlan
    from repro_torch.configs.gnn import small_gnn_config
    from repro_torch.pipeline.prefetcher import SamplingPlan
    ps, jps = parts_pair
    kw = dict(batch_size=24, feat_dim=8, num_classes=5, fanouts=(3, 4))
    plan = SamplingPlan(ps, small_gnn_config("graphsage", **kw), base_seed)
    jplan = JPlan(jps, j_cfg("graphsage", **kw), base_seed)
    for ep in range(2):
        sched, jsched = plan.epoch_schedule(ep), jplan.epoch_schedule(ep)
        assert len(sched) == len(jsched) > 1
        for row, jrow in zip(sched, jsched):
            for x, y in zip(row, jrow):
                assert_same(x, y)
        for step in (0, len(sched) - 1):
            assert_same_batch(plan.sample_host(ep, step, sched[step]),
                              jplan.sample_host(ep, step, jsched[step]))
        batches = list(plan.batches(sched, ep))
        assert len(batches) == len(sched)
        assert_same_batch(batches[-1], jplan.sample_host(
            ep, len(sched) - 1, jsched[-1]))


def test_eval_minibatches_identical(parts_pair):
    from repro.configs.gnn import small_gnn_config as j_cfg
    from repro.pipeline.staging import MinibatchPipeline
    from repro_torch.configs.gnn import small_gnn_config
    from repro_torch.pipeline.prefetcher import SamplingPlan
    from repro_torch.pipeline.staging import EVAL_EPOCH_TAG, eval_schedule
    ps, jps = parts_pair
    kw = dict(batch_size=16, feat_dim=8, num_classes=5, fanouts=(3, 4))
    plan = SamplingPlan(ps, small_gnn_config("graphsage", **kw), 123)
    got = list(plan.batches(eval_schedule(plan, 3, 123),
                            EVAL_EPOCH_TAG + 123))
    want = list(MinibatchPipeline(jps, j_cfg("graphsage", **kw),
                                  base_seed=123).eval_batches(3, seed=123))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert_same_batch(a, {k: [np.asarray(x) for x in v]
                              if isinstance(v, list) else np.asarray(v)
                              for k, v in b.items()})


def test_dist_data_tables_identical(parts_pair):
    """``build_dist_data``'s tables and the exchange plan's push contract
    are the reference's, bit for bit."""
    import torch
    from repro.comm.plan import build_exchange_plan as j_plan
    from repro.configs.gnn import small_gnn_config as j_cfg
    from repro.train.gnn_trainer import build_dist_data as j_build
    from repro_torch.comm.plan import build_exchange_plan
    from repro_torch.configs.gnn import small_gnn_config
    from repro_torch.train.gnn_trainer import build_dist_data
    ps, jps = parts_pair
    got = build_dist_data(ps, small_gnn_config("graphsage"),
                          torch.device("cpu"))
    want = j_build(jps, j_cfg("graphsage"))
    for k in ("features", "labels", "num_solid", "vid_o", "push_mask"):
        assert_same(got[k].numpy(), want[k])
    assert_same(build_exchange_plan(ps).push_mask, j_plan(jps).push_mask)
    for i in range(3):
        for j in range(3):
            assert_same(ps.db_halo(i, j), jps.db_halo(i, j))
