"""The port's own copies of the reference's small public names, each held
to the reference: ``Graph.degrees``, ``Partition.is_halo_p``,
``QueryRouter.seeds_of``, ``sgd_update``, ``LatencyStats``,
``hec_load``/``set_index`` and the ``core/hec.py`` shim."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import hec as ref_hec
from repro.core import hec as ref_core_hec
from repro.graph import partition_graph as ref_partition
from repro.graph import synthetic_graph as ref_synthetic
from repro.serve.gnn import LatencyStats as RefLatencyStats
from repro.serve.gnn.distributed.router import QueryRouter as RefRouter
from repro.train.optimizer import sgd_update as ref_sgd
from repro_torch.cache import hec
from repro_torch.core import hec as core_hec
from repro_torch.graph import partition_graph, synthetic_graph
from repro_torch.serve.gnn import LatencyStats
from repro_torch.serve.gnn.distributed.router import QueryRouter
from repro_torch.train.optimizer import sgd_update


@pytest.fixture(scope="module")
def graphs():
    kw = dict(num_vertices=900, avg_degree=6, num_classes=4, feat_dim=8,
              seed=3)
    return synthetic_graph(**kw), ref_synthetic(**kw)


def test_graph_degrees(graphs):
    g, rg = graphs
    assert np.array_equal(g.degrees(), rg.degrees())


def test_partition_is_halo_p(graphs):
    g, rg = graphs
    p, rp = partition_graph(g, 3, seed=0).parts[1], \
        ref_partition(rg, 3, seed=0).parts[1]
    vid_p = np.arange(p.num_solid + p.num_halo)
    assert np.array_equal(p.is_halo_p(vid_p), rp.is_halo_p(vid_p))


def test_router_seeds_of():
    entries = [(object(), 5), (object(), 0), (object(), 17)]
    got, want = QueryRouter.seeds_of(entries), RefRouter.seeds_of(entries)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_sgd_update():
    rng = np.random.default_rng(0)
    ps = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,))]
    gs = [rng.normal(size=p.shape).astype(np.float32) for p in ps]
    want = ref_sgd([jnp.asarray(g) for g in gs],
                   [jnp.asarray(p) for p in ps], 0.05)
    got = sgd_update([torch.as_tensor(g) for g in gs],
                     [torch.as_tensor(p.copy()) for p in ps], 0.05)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_latency_stats():
    lat, ref = LatencyStats(), RefLatencyStats()
    for v in np.random.default_rng(1).exponential(0.01, 500):
        lat.observe(float(v))
        ref.observe(float(v))
    assert lat.metrics() == ref.metrics()


def test_hec_load_and_set_index():
    rng = np.random.default_rng(2)
    st = hec.hec_init(256, 4, 8, "cpu")
    st.values.copy_(torch.as_tensor(rng.normal(size=st.values.shape)
                                    .astype(np.float32)))
    init = ref_hec.hec_init(256, 4, 8)
    rst = ref_hec.HECState(tags=init.tags, age=init.age,
                           values=jnp.asarray(st.values.numpy()))
    s = rng.integers(0, st.values.shape[0], 40)
    w = rng.integers(0, 4, 40)
    got = hec.hec_load(st, torch.as_tensor(s), torch.as_tensor(w))
    want = ref_hec.hec_load(rst, jnp.asarray(s), jnp.asarray(w))
    assert np.array_equal(got.numpy(), np.asarray(want))
    vids = rng.integers(-5, 1 << 30, 200).astype(np.int32)
    assert np.array_equal(
        hec.set_index(torch.as_tensor(vids), 64).numpy(),
        np.asarray(ref_hec.set_index(jnp.asarray(vids), 64)))


def test_core_hec_shim():
    names = set(ref_core_hec.__all__) | {"_set_index"}
    for name in names:
        assert getattr(core_hec, name) is getattr(hec, name)
    assert set(core_hec.__all__) == set(ref_core_hec.__all__)
