"""The port's CUDA kernels on the card, against their plain PyTorch
versions (which ``test_torch_kernels.py`` holds against the reference).

Every test here needs a CUDA device: it is marked ``cuda`` and skips
elsewhere.  The file imports neither ``jax`` nor ``repro``, so it runs on
a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerance: the serve layer sums float32 in another order than its plain
version, so |kernel - plain| <= 1e-4 * max(1, |plain|); the HEC probe +
load is held bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.cache import hec
from repro_torch.kernels import hec_search, ref, serve_fused

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def close(got, want):
    return bool(((got - want).abs() <= 1e-4 * want.abs().clamp_min(1.0)).all())


def serve_inputs(dev, seed, N, M, f, D, K, self_idx):
    rng = np.random.default_rng(seed)
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    nbr = rng.integers(-1, N, (M, f)).astype(np.int32)
    nbr[1] = -1                                    # an all-masked row
    return dict(
        h_src=t(rng.normal(size=(N, D)).astype(np.float32)), nbr_idx=t(nbr),
        src_valid=t(rng.random(N) > 0.2),
        wn=t((rng.normal(size=(D, K)) * 0.1).astype(np.float32)),
        ws=t((rng.normal(size=(D, K)) * 0.1).astype(np.float32)),
        b=t((rng.normal(size=K) * 0.1).astype(np.float32)),
        self_idx=t(rng.integers(-3, N + 3, M).astype(np.int32))
        if self_idx else None)


@pytest.mark.parametrize("N,M,f,D,K", [
    (64, 16, 5, 32, 32), (300, 37, 7, 24, 47), (257, 64, 3, 16, 130),
    (40, 40, 9, 8, 5), (2000, 512, 10, 256, 172), (1200, 100, 4, 400, 300),
    (100000, 2048, 77, 128, 256)])
@pytest.mark.parametrize("self_idx", [False, True])
@pytest.mark.parametrize("relu", [True, False])
def test_serve_kernel_matches_plain(dev, N, M, f, D, K, self_idx, relu):
    kw = serve_inputs(dev, N + D, N, M, f, D, K, self_idx)
    before = serve_fused.serve_fused_layer.launches
    got = serve_fused.serve_fused_layer(relu=relu, **kw)
    torch.cuda.synchronize()
    assert serve_fused.serve_fused_layer.launches == before + 1
    assert close(got, ref.serve_layer_ref(relu=relu, **kw))


def filled_state(dev, seed, cache_size, ways, d):
    rng = np.random.default_rng(seed)
    st = hec.hec_init(cache_size, ways, d, dev)
    for _ in range(6):
        vids = rng.integers(-1, 3 * cache_size, 64)
        vids[:16] = vids[0]                        # duplicates in one batch
        hec.hec_store(st, torch.as_tensor(vids, device=dev),
                      torch.randn(64, d, device=dev))
    return st


EDGE_VIDS = [-1, -2, -5, -2 ** 31, 2 ** 31 - 1, 0, 1, 255, 256]


@pytest.mark.parametrize("cache_size,ways,d", [
    (64, 4, 8), (256, 8, 5), (96, 32, 3), (65536, 8, 256), (4096, 8, 172)])
def test_hec_kernel_bitmatches_plain(dev, cache_size, ways, d):
    st = filled_state(dev, cache_size + d, cache_size, ways, d)
    probe = torch.cat([torch.tensor(EDGE_VIDS, dtype=torch.int32, device=dev),
                       st.tags.ravel(),
                       torch.randint(0, 3 * cache_size, (100,),
                                     dtype=torch.int32, device=dev)])
    before = hec_search.hec_lookup.launches
    got = hec_search.hec_lookup(st.tags, st.values, probe)
    want = hec_search.hec_lookup_ref(st.tags, st.values, probe)
    torch.cuda.synchronize()
    assert hec_search.hec_lookup.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)
    assert bool(got[0].any()) and not bool(got[0][:4].any())


def test_store_on_card_matches_cpu(dev):
    """``hec_store``'s duplicate resolution is deterministic on the card."""
    rng = np.random.default_rng(0)
    a = hec.hec_init(64, 4, 3, dev)
    b = hec.hec_init(64, 4, 3, torch.device("cpu"))
    for _ in range(8):
        vids = torch.as_tensor(rng.integers(-1, 200, 80))
        vids[:20] = 7                              # > ways entries, one set
        embs = torch.as_tensor(rng.normal(size=(80, 3)).astype(np.float32))
        hec.hec_store(a, vids.to(dev), embs.to(dev))
        hec.hec_store(b, vids, embs)
    for x, y in ((a.tags, b.tags), (a.age, b.age), (a.values, b.values)):
        assert torch.equal(x.cpu(), y)


def test_wrappers_check_operands(dev):
    kw = serve_inputs(dev, 0, 50, 20, 4, 8, 6, False)
    with pytest.raises(ValueError, match="dtype"):
        serve_fused.serve_fused_layer(**{**kw, "nbr_idx": kw["nbr_idx"].long()})
    with pytest.raises(ValueError, match="contiguous"):
        serve_fused.serve_fused_layer(
            **{**kw, "wn": kw["wn"].T.contiguous().T})
    with pytest.raises(ValueError, match="on"):
        serve_fused.serve_fused_layer(**{**kw, "b": kw["b"].cpu()})
    with pytest.raises(ValueError, match="ways"):
        hec_search.hec_lookup(
            torch.full((2, 33), -1, dtype=torch.int32, device=dev),
            torch.zeros(2, 33, 4, device=dev),
            torch.zeros(3, dtype=torch.int32, device=dev))


def test_scheduler_on_card_matches_cpu(dev):
    """The serve path through the kernels == the same path through the
    plain versions: answers within tolerance, counters and tags equal."""
    from repro_torch.configs.gnn import small_gnn_config
    from repro_torch.graph import partition_graph, synthetic_graph
    from repro_torch.models.gnn.graphsage import GraphSAGE
    from repro_torch.serve.gnn import (GNNServeConfig, GNNServeScheduler,
                                       ServeCacheConfig)
    part = partition_graph(synthetic_graph(num_vertices=600, avg_degree=6,
                                           num_classes=5, feat_dim=16,
                                           seed=1), 1).parts[0]
    cfg = small_gnn_config("graphsage", feat_dim=16, num_classes=5,
                           hidden_size=32, num_hidden_layers=2,
                           fanouts=(3, 4, 5))
    vids = np.random.default_rng(3).integers(0, 300, 120)
    outs, servers = [], []
    for device in (dev, torch.device("cpu")):
        srv = GNNServeScheduler(
            cfg, GraphSAGE.from_config(cfg, seed=7), part,
            GNNServeConfig(num_slots=8,
                           cache=ServeCacheConfig(cache_size=256, ways=4)),
            device=device)
        outs.append(np.concatenate([srv.serve(vids), srv.serve(vids[::-1])]))
        servers.append(srv)
    assert close(torch.as_tensor(outs[0]), torch.as_tensor(outs[1]))
    m_gpu, m_cpu = (s.metrics() for s in servers)
    for k in ("steps_run", "fast_path_hits", "hits_l1", "hits_l2", "hits_l3",
              "lookups_l1", "lookups_l2", "lookups_l3"):
        assert m_gpu[k] == m_cpu[k], k
    for a, b in zip(*(s.cache.states for s in servers)):
        assert torch.equal(a.tags.cpu(), b.tags)
