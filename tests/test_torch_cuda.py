"""The port's CUDA kernels on the card, against their plain PyTorch
versions (which ``test_torch_kernels.py`` holds against the reference).

Every test here needs a CUDA device: it is marked ``cuda`` and skips
elsewhere.  The file imports neither ``jax`` nor ``repro``, so it runs on
a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerance: the serve layer, UPDATE (forward and backward), AGG and GAT
AGG sum float32 in another order than their plain versions, so
|kernel - plain| <= 1e-4 * max(1, |plain|); the AGG and GAT AGG
gradients (F and H) sum in a fixed order, so they repeat bit for bit
from launch to launch, F is its plain version's bits wherever a source
row has at most ``slot_index.CHUNK`` slots, and two trainings from the
same state give the same bits; the dropout's zero pattern,
UPDATE's dZ (and its db from one call to the next), the HEC probe + load
(single and batched) and the fanout draw are held bit for bit, UPDATE's
forward bit for bit to its pinned outputs, and AGG's forward (mean and
count) bit for bit to its first design's pinned outputs.  On NaN (and,
for AGG, +-inf) rows C, A, E and G give NaN exactly where their plain
versions do, and H does on a fanout whose every slot is included; the
resilience plane's armed step is the unarmed step's bits and launches,
and a skipped step leaves the parameters, moments and Adam's count.
LM serving (plain torch, no kernel) is held to the CPU: logits and
cache states within 1e-4 * max(1, |x|) (xLSTM within 4x the card's own
spread), positions and greedy ids equal; the scheduler's ids to each
request decoded alone; bfloat16 prefill to its replay within the
reference test's atol = rtol = 2e-2 at reduced depth; bfloat16 on the
card to the CPU: 99% of an attention's bf16 outputs bit for bit,
logits within 0.65 of the CPU's bf16-float32 rms distance.
"""
import hashlib

import numpy as np
import pytest
import torch

from repro_torch.cache import hec
from repro_torch.kernels import (_build, gat_edge, hec_search, nonfinite,
                                 ref, sage_agg, sample_draw, serve_fused,
                                 slot_index, update_fused)

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


# kernel A: every form serve_tile picks on an H100 (64, 32 or 16 rows, all
# column tiles or one), with float4 and scalar gathers (D or K off 4),
# D = 400, ragged K and M, f from 3 to 77, the serving paths' shapes
SERVE_SHAPES = [
    (64, 16, 5, 32, 32), (300, 37, 7, 24, 47), (257, 64, 3, 16, 130),
    (40, 40, 9, 8, 5), (2000, 512, 10, 256, 172), (1200, 100, 4, 400, 300),
    (100000, 2048, 77, 128, 256), (1024, 64, 15, 256, 172),
    (100000, 2048, 77, 256, 256), (500, 100, 5, 6, 128),
    (67584, 11264, 5, 128, 256), (5000, 2048, 9, 128, 320),
    (30000, 4224, 6, 100, 66), (20000, 11264, 5, 130, 256),
    (30000, 4224, 6, 128, 64), (5000, 2048, 9, 130, 320),
    (10000, 2048, 12, 128, 130)]


@pytest.mark.parametrize("N,M,f,D,K", SERVE_SHAPES)
@pytest.mark.parametrize("self_idx", [False, True])
@pytest.mark.parametrize("relu", [True, False])
def test_serve_kernel_matches_plain(dev, N, M, f, D, K, self_idx, relu):
    kw = serve_inputs(dev, N + D, N, M, f, D, K, self_idx)
    before = serve_fused.serve_fused_layer.launches
    got = serve_fused.serve_fused_layer(relu=relu, **kw)
    torch.cuda.synchronize()
    assert serve_fused.serve_fused_layer.launches == before + 1
    assert close(got, ref.serve_layer_ref(relu=relu, **kw))


def test_serve_takes_every_form(dev):
    """SERVE_SHAPES reach every (rows, column tiles) form of kernel A, each
    with the float4 gather and the scalar one."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    forms = set()
    for _, M, _, D, K in SERVE_SHAPES:
        bm, tiles = serve_fused.serve_tile(M, K, D, sms)
        forms.add((bm, tiles == -(-K // 64), D % 4 == 0 and K % 4 == 0))
    assert forms == {(bm, every, vec) for bm in serve_fused.BMS
                     for every in (True, False) for vec in (True, False)}


@pytest.mark.parametrize("N,M,f,D,K", [(67584, 11264, 5, 128, 256),
                                       (100000, 2048, 77, 256, 256),
                                       (1024, 64, 15, 256, 172)])
def test_serve_kernel_takes_unaligned_h(dev, N, M, f, D, K):
    """An h view 4 bytes off a 16-byte boundary takes the scalar gather
    and gives what the aligned copy gives, within tolerance."""
    kw = serve_inputs(dev, N + D, N, M, f, D, K, True)
    base = torch.empty(N * D + 1, device=dev)
    h = base[1:].view(N, D)
    h.copy_(kw["h_src"])
    assert h.data_ptr() % 16 == 4 and h.is_contiguous()
    got = serve_fused.serve_fused_layer(**{**kw, "h_src": h})
    want = serve_fused.serve_fused_layer(**kw)
    torch.cuda.synchronize()
    assert close(got, ref.serve_layer_ref(**kw)) and close(got, want)


def test_serve_smem_matches_the_source(dev):
    """The wrapper's shared-memory sizes are the kernel's own."""
    lib = _build.load("serve_fused", serve_fused._SIGNATURES)
    for bm in serve_fused.BMS:
        for D in (5, 6, 128, 172, 256, 400, 1000):
            assert lib.serve_fused_smem(bm, D) == serve_fused.smem_bytes(bm, D)


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
    (64, 4, 8), (256, 8, 5), (96, 32, 3), (65536, 8, 256), (4096, 8, 172),
    (65536, 8, 1024)])
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


def stacked_state(dev, seed, R, cache_size, ways, d):
    """R filled caches stacked on a leading rank axis."""
    parts = [filled_state(dev, seed + r, cache_size, ways, d)
             for r in range(R)]
    return hec.HECState(tags=torch.stack([p.tags for p in parts]),
                        age=torch.stack([p.age for p in parts]),
                        values=torch.stack([p.values for p in parts]))


@pytest.mark.parametrize("R,B,n,cache_size,ways,d,dead", [
    (4, 4, 1024, 65536, 8, 256, None), (4, 4, 1024, 65536, 8, 1024, None),
    (4, 4, 77, 4096, 8, 172, 2), (3, 2, 33, 256, 4, 5, 0),
    (1, 1, 1, 64, 32, 3, None)])
def test_batched_probe_kernel_bitmatches_plain(dev, R, B, n, cache_size,
                                               ways, d, dead):
    """Kernel J == ``hec_probe_ref`` bit for bit: the cache fetch's shapes
    (4 responders x 4 requesters x up to 1,024 slots at d 256 and 1,024)
    and ragged ones (n off 32, d off 4, negative vids, a dead
    responder)."""
    st = stacked_state(dev, cache_size + d, R, cache_size, ways, d)
    gen = torch.Generator(device="cpu").manual_seed(d + n)
    vids = torch.randint(-3, 3 * cache_size, (R, B, n), generator=gen,
                         dtype=torch.int32)
    for r in range(R):                 # hits: each responder's own tags
        own = st.tags[r].ravel().cpu()
        own = own[own >= 0]
        k = min(max(n // 2, 1), own.numel())
        vids[r, 0, :k] = own[:k]
    if B > 1:                          # edge vids in the last requester's
        m = min(len(EDGE_VIDS), n)
        vids[:, -1, :m] = torch.tensor(EDGE_VIDS[:m], dtype=torch.int32)
    vids = vids.to(dev)
    alive = None
    if dead is not None:
        alive = torch.ones(R, dtype=torch.bool, device=dev)
        alive[dead] = False
    before = hec_search.hec_probe.launches
    got = hec_search.hec_probe(st.tags, st.values, vids, alive)
    want = hec_search.hec_probe_ref(st.tags, st.values, vids, alive)
    torch.cuda.synchronize()
    assert hec_search.hec_probe.launches == before + 1
    assert got.shape == want.shape == (R, B, n, d + 1)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool((got[..., d] > 0).any())
    if dead is not None:
        assert not bool(got[dead, ..., d].any())


def test_sharded_scheduler_on_card_matches_cpu(dev):
    """The sharded serve path through the kernels (A, B, J) == the same
    path through the plain versions, with the hot tier, dedup and round
    batching on: answers within tolerance, counters, tags and ages
    equal."""
    from repro_torch.configs.gnn import small_gnn_config
    from repro_torch.graph import partition_graph, synthetic_graph
    from repro_torch.models.gnn import build_model
    from repro_torch.serve.gnn import ServeCacheConfig, prewarm
    from repro_torch.serve.gnn.distributed import (DistGNNServeScheduler,
                                                   DistServeConfig)
    ps = partition_graph(synthetic_graph(num_vertices=1500, avg_degree=6,
                                         num_classes=5, feat_dim=16, seed=1),
                         4)
    vids = np.random.default_rng(3).integers(0, 1500, 300)
    for model in ("graphsage", "gat"):
        cfg = small_gnn_config(model, feat_dim=16, num_classes=5,
                               hidden_size=16, num_hidden_layers=2,
                               fanouts=(3, 4, 5))
        outs, servers = [], []
        for device in (dev, torch.device("cpu")):
            srv = DistGNNServeScheduler(
                cfg, build_model(cfg, seed=7, device=device), ps,
                DistServeConfig(num_slots=8, halo_slots=16, hot_size=64,
                                dedup=True, round_batch=2,
                                cache=ServeCacheConfig(cache_size=512,
                                                       ways=4)),
                device=device)
            prewarm(srv, frac=0.1, chunk_size=256)
            outs.append(np.concatenate([srv.serve(vids),
                                        srv.serve(vids[::-1])]))
            servers.append(srv)
        assert close(torch.as_tensor(outs[0]), torch.as_tensor(outs[1]))
        m_gpu, m_cpu = (s.metrics() for s in servers)
        for k in m_cpu:
            if not k.startswith("latency"):
                assert m_gpu[k] == m_cpu[k], k
        assert m_cpu["halo_fetched"] > 0 and m_cpu["hot_hits"] > 0
        for a, b in zip(*(s.cache.states for s in servers)):
            assert torch.equal(a.tags.cpu(), b.tags)
        for a, b in zip(*(s.hot.states for s in servers)):
            assert torch.equal(a.age.cpu(), b.age)


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
            cfg, GraphSAGE.from_config(cfg, seed=7, device=device), part,
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


# ---------------------------------------------------------------------------
# training kernels: UPDATE (C, D) and AGG (E, F)
# ---------------------------------------------------------------------------
UPDATE_SHAPES = [(64, 32, 64), (300, 96, 130), (257, 128, 256), (16, 100, 47),
                 (1000, 256, 172), (16000, 256, 256)]


def update_inputs(dev, seed, N, C, K):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.as_tensor(  # noqa: E731
        rng.normal(size=s).astype(np.float32), device=dev)
    return dict(agg=t(N, C), self_h=t(N, C), wn=t(C, K) * 0.1,
                ws=t(C, K) * 0.1, b=t(K) * 0.1)


@pytest.mark.parametrize("N,C,K", UPDATE_SHAPES)
@pytest.mark.parametrize("relu,dropout", [(True, 0.0), (True, 0.5),
                                          (False, 0.0), (False, 0.1)])
def test_update_kernels_match_plain(dev, N, C, K, relu, dropout):
    kw = update_inputs(dev, N + K, N, C, K)
    seed = 2 ** 32 - 3
    before = (update_fused.update_fused_fwd.launches,
              update_fused.update_fused_bwd.launches)
    out = update_fused.update_fused_fwd(relu=relu, dropout=dropout,
                                        seed=seed, **kw)
    want = ref.fused_update_ref(relu=relu, dropout=dropout, seed=seed, **kw)
    torch.cuda.synchronize()
    assert close(out, want)
    if dropout:
        # the dropped positions are exactly the hash's; elsewhere a zero
        # may differ only where ReLU meets a pre-activation within rounding
        from repro_torch.models.gnn.common import hash_uniform
        dropped = hash_uniform(seed, torch.arange(N, device=dev),
                               torch.arange(K, device=dev)) < dropout
        assert bool((out[dropped] == 0).all())
        differ = (out == 0) != (want == 0)
        assert not bool((differ & (dropped | (want.abs() > 1e-4))).any())
    g = torch.randn(N, K, device=dev)
    dz, db = update_fused.update_fused_bwd(g, want, relu=relu,
                                           dropout=dropout, seed=seed)
    dz_p, db_p = ref.fused_update_bwd_ref(g, want, relu=relu,
                                          dropout=dropout, seed=seed)
    torch.cuda.synchronize()
    assert torch.equal(dz, dz_p)
    assert close(db, db_p)
    assert (update_fused.update_fused_fwd.launches,
            update_fused.update_fused_bwd.launches) == \
        (before[0] + 1, before[1] + 1)


# kernel C's two block tiles, 16-byte and 4-byte staging, N off every
# tile, K = 172, C up to 1,024
UPDATE_TILE_SHAPES = [(1000, 128, 172), (999, 256, 172), (1001, 1024, 172),
                      (17001, 256, 256), (20000, 100, 130), (3000, 1024, 172)]


@pytest.mark.parametrize("N,C,K", UPDATE_TILE_SHAPES)
@pytest.mark.parametrize("relu,dropout", [(True, 0.1), (False, 0.0),
                                          (False, 0.3)])
def test_update_fwd_tiles_match_plain(dev, N, C, K, relu, dropout):
    """Kernel C (3xTF32 on the tensor cores) in both tiles against the
    plain float32 version: within 1e-4 * max(1, |x|), the dropout's
    dropped positions exactly zero and no other zero but where the
    pre-activation is within rounding of it."""
    from repro_torch.models.gnn.common import hash_uniform
    kw = update_inputs(dev, N * 7 + C + K, N, C, K)
    seed = 12345
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert update_fused.fwd_route(N, K, sms).startswith("3xTF32")
    out = update_fused.update_fused_fwd(relu=relu, dropout=dropout,
                                        seed=seed, **kw)
    want = ref.fused_update_ref(relu=relu, dropout=dropout, seed=seed, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and close(out, want)
    dropped = hash_uniform(seed, torch.arange(N, device=dev),
                           torch.arange(K, device=dev)) < dropout
    assert bool((out[dropped] == 0).all())
    differ = (out == 0) != (want == 0)
    assert not bool((differ & (dropped | (want.abs() > 1e-4))).any())


def test_update_fwd_takes_both_tiles(dev):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert {update_fused.fwd_tile(N, K, sms)
            for N, _, K in UPDATE_TILE_SHAPES} == {0, 1}


# kernel C's output on pinned inputs, as the kernel gave it on an H100
# before its 3xTF32 helpers moved into csrc/tf32x3.cuh (SHA-256 of the
# float32 bytes): both tiles, both copy widths, with and without dropout
C_PINNED = [
    ((17001, 256, 256, True, 0.1),
     "35930f6aed084ade7e76f20625e439c7346f73fbb7930c19ebf333002f8f0807"),
    ((1000, 256, 172, False, 0.0),
     "7266dfd4337d180bee09fc7814a2fe422cfee76751e6f36e861c8a325dd7715d"),
    ((1001, 100, 130, False, 0.3),
     "a93244ebe3a2f34929c9ac9dbcac155c3f551b94434c17412afdf9e06d50035c")]


@pytest.mark.parametrize("shape,digest", C_PINNED)
def test_update_fwd_bitmatches_pinned_output(dev, shape, digest):
    N, C, K, relu, dropout = shape
    rng = np.random.default_rng(N + C + K)
    t = lambda *s: torch.as_tensor(  # noqa: E731
        rng.normal(size=s).astype(np.float32), device=dev)
    args = [t(N, C), t(N, C), t(C, K) * 0.1, t(C, K) * 0.1, t(K) * 0.1]
    out = update_fused.update_fused_fwd(*args, relu=relu, dropout=dropout,
                                        seed=12345)
    got = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
    assert got == digest


@pytest.mark.parametrize("N", [1000, 16000, 17001])
@pytest.mark.parametrize("K", [172, 256, 130])
@pytest.mark.parametrize("relu,dropout", [(True, 0.1), (True, 0.0),
                                          (False, 0.3), (False, 0.0)])
def test_update_bwd_matches_plain_and_repeats(dev, N, K, relu, dropout):
    """Kernel D: dZ bit for bit the plain version's, db within tolerance
    of it and bit for bit the same over two calls (a fixed order, no
    float atomics); one wrapper call per launch count."""
    gen = torch.Generator(device=dev).manual_seed(N + K)
    g = torch.randn(N, K, generator=gen, device=dev)
    out = torch.randn(N, K, generator=gen, device=dev)
    if relu:
        out = torch.relu(out)
    kw = dict(relu=relu, dropout=dropout, seed=2 ** 32 - 5)
    before = update_fused.update_fused_bwd.launches
    dz, db = update_fused.update_fused_bwd(g, out, **kw)
    dz2, db2 = update_fused.update_fused_bwd(g, out, **kw)
    dz_p, db_p = ref.fused_update_bwd_ref(g, out, **kw)
    torch.cuda.synchronize()
    assert update_fused.update_fused_bwd.launches == before + 2
    assert torch.equal(dz, dz_p) and torch.equal(dz2, dz_p)
    assert close(db, db_p)
    assert torch.equal(db.view(torch.int32), db2.view(torch.int32))


def test_update_bwd_takes_unaligned_g(dev):
    """A g view off a 16-byte boundary takes the scalar path: dZ still bit
    for bit the plain version's."""
    N, K = 16000, 256
    base = torch.randn(N * K + 1, device=dev)
    g = base[1:].view(N, K)
    out = torch.relu(torch.randn(N, K, device=dev))
    dz, db = update_fused.update_fused_bwd(g, out, dropout=0.1, seed=3)
    dz_p, db_p = ref.fused_update_bwd_ref(g, out, dropout=0.1, seed=3)
    torch.cuda.synchronize()
    assert torch.equal(dz, dz_p) and close(db, db_p)


AGG_SHAPES = [(100, 30, 5, 32), (333, 64, 9, 64), (50, 50, 1, 128),
              (300, 37, 7, 6), (176000, 16000, 10, 256)]


@pytest.mark.parametrize("N,M,f,D", AGG_SHAPES)
def test_agg_kernels_match_plain(dev, N, M, f, D):
    rng = np.random.default_rng(N + D)
    nbr = rng.integers(-1, N, (M, f)).astype(np.int32)
    nbr[0] = -1                                    # an all-masked row
    h = torch.as_tensor(rng.normal(size=(N, D)).astype(np.float32),
                        device=dev)
    nbr = torch.as_tensor(nbr, device=dev)
    valid = torch.as_tensor(rng.random(N) > 0.15, device=dev)
    before = (sage_agg.sage_agg_fwd.launches, sage_agg.sage_agg_bwd.launches)
    mean, cnt = sage_agg.sage_agg_fwd(h, nbr, valid)
    mean_p, cnt_p = ref.sage_agg_ref(h, nbr, valid)
    torch.cuda.synchronize()
    assert close(mean, mean_p) and torch.equal(cnt, cnt_p)
    assert float(mean[0].abs().max()) == 0.0
    g = torch.randn(M, D, device=dev)
    dh = sage_agg.sage_agg_bwd(g, nbr, valid, cnt, N)
    dh_p = ref.sage_agg_bwd_ref(g, nbr, valid, cnt_p, N)
    torch.cuda.synchronize()
    assert close(dh, dh_p)
    assert (sage_agg.sage_agg_fwd.launches, sage_agg.sage_agg_bwd.launches) \
        == (before[0] + 1, before[1] + 1)


# kernel E's mean and count on pinned inputs, as its first design (one
# warp per dst row) gave them on an H100 (SHA-256 of the float32 bytes of
# mean, then of cnt): D 128, 256, 100 and 6 (the scalar path), f 1, 5, 15
# and 77, M = 1 and 3; tools/draw_agg_compare.py prints them
E_PINNED = [
    ((5000, 1000, 5, 128),
     "db9fa39a2d47e051be0849485c44e8cdc0841f71ad53f532b2993ce432ec5d41"),
    ((3000, 1000, 15, 256),
     "2adf8fe789319ddbc7cdff7c596a7df14ec3718a5e34c16860f211bc0c21bafc"),
    ((1000, 257, 77, 100),
     "decb540a9d77c59ddc26a4f9abb85c52700909f8792022c80b4a0a14a90920c6"),
    ((300, 37, 7, 6),
     "0d886f3041398c35957efb879347c7391cc98204923e53999ac6f0f7fb810d59"),
    ((100, 1, 1, 128),
     "6fccf64883a8a1239c04e92532142750460e412d3e8d93bbe5f2d83b82f5e145"),
    ((200, 3, 15, 256),
     "eacc8862669941398839226fef97f6e8fc061fcd246ddf3805932ed9d23e1104"),
    ((500, 40, 1, 6),
     "935cbae12906a653f9f5ba5180fa312b87e047dd8a4760365bf5a58c36589f00")]


def pinned_agg_inputs(dev, N, M, f, D):
    """Normals, indices in [-1, N + 2) (past the last row they clamp to
    it), 85% of the rows valid, row 0 all -1."""
    rng = np.random.default_rng(N + M + f + D)
    h = rng.normal(size=(N, D)).astype(np.float32)
    nbr = rng.integers(-1, N + 2, (M, f)).astype(np.int32)
    nbr[0] = -1
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    return t(h), t(nbr), t(rng.random(N) > 0.15)


def agg_digest(mean, cnt):
    return hashlib.sha256(mean.cpu().numpy().tobytes()
                          + cnt.cpu().numpy().tobytes()).hexdigest()


@pytest.mark.parametrize("shape,digest", E_PINNED)
def test_agg_fwd_bitmatches_pinned_output(dev, shape, digest, monkeypatch):
    """E at its own form and at forced ones (one row a warp, 32 rows a
    warp, more rows than M, 128-column slices), on an aligned h and on a
    view 4 bytes off a 16-byte boundary (the scalar path): every time
    the first design's bits, and within tolerance of the plain version."""
    N, M, f, D = shape
    h, nbr, valid = pinned_agg_inputs(dev, *shape)
    base = torch.empty(N * D + 1, device=dev)
    unaligned = base[1:].view(N, D)
    unaligned.copy_(h)
    assert unaligned.data_ptr() % 16 == 4 and unaligned.is_contiguous()
    want, want_cnt = ref.sage_agg_ref(h, nbr, valid)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    forms = [sage_agg.agg_form(M, f, D, sms), (1, 128), (32, 128),
             (M + 5, 128), (3, -(-D // 128) * 128)]
    for form in forms:
        monkeypatch.setattr(sage_agg, "agg_form", lambda *a, form=form: form)
        for hh in (h, unaligned):
            before = sage_agg.sage_agg_fwd.launches
            mean, cnt = sage_agg.sage_agg_fwd(hh, nbr, valid)
            torch.cuda.synchronize()
            assert sage_agg.sage_agg_fwd.launches == before + 1
            assert agg_digest(mean, cnt) == digest, form
            assert close(mean, want) and torch.equal(cnt, want_cnt)


def test_agg_fwd_rejects_a_bad_form(dev, monkeypatch):
    """A slice that is not a positive multiple of 128 is refused."""
    h, nbr, valid = pinned_agg_inputs(dev, 100, 4, 3, 8)
    monkeypatch.setattr(sage_agg, "agg_form", lambda *a: (1, 100))
    with pytest.raises(RuntimeError, match="CUDA error"):
        sage_agg.sage_agg_fwd(h, nbr, valid)


def test_autograd_through_kernels_matches_plain(dev):
    """UPDATE after AGG, differentiated on the card (kernels C-F) and on
    the CPU (plain versions): the same loss, the same gradients."""
    rng = np.random.default_rng(5)
    N, M, f, C, K = 900, 200, 6, 48, 40
    arrs = dict(h=rng.normal(size=(N, C)).astype(np.float32),
                wn=(rng.normal(size=(C, K)) * 0.2).astype(np.float32),
                ws=(rng.normal(size=(C, K)) * 0.2).astype(np.float32),
                b=(rng.normal(size=K) * 0.1).astype(np.float32))
    nbr = rng.integers(-1, N, (M, f)).astype(np.int32)
    valid = rng.random(N) > 0.1
    res = []
    for d in (dev, torch.device("cpu")):
        t = {k: torch.as_tensor(v, device=d).requires_grad_()
             for k, v in arrs.items()}
        agg = sage_agg.sage_agg(t["h"], torch.as_tensor(nbr, device=d),
                                torch.as_tensor(valid, device=d))
        out = update_fused.fused_update(agg, t["h"][:M], t["wn"], t["ws"],
                                        t["b"], relu=True, dropout=0.3,
                                        seed=11)
        loss = (out * out).sum()
        grads = torch.autograd.grad(loss, list(t.values()))
        res.append([loss] + list(grads))
    for a, b in zip(*res):
        assert close(a.cpu(), b)


def test_two_training_steps_on_card_match_cpu(dev):
    """Two aep steps of 4 ranks through the kernels == the same steps
    through the plain versions: loss and parameters within tolerance, HEC
    tags and the pushed tags equal."""
    from repro_torch.configs.gnn import HECConfig, small_gnn_config
    from repro_torch.graph import partition_graph, synthetic_graph
    from repro_torch.pipeline.prefetcher import SamplingPlan
    from repro_torch.train.gnn_trainer import (DistTrainer, build_dist_data,
                                               default_push_uniforms,
                                               minibatch_to_device)
    g = synthetic_graph(num_vertices=2000, avg_degree=8, num_classes=6,
                        feat_dim=24, seed=0)
    ps = partition_graph(g, 4, seed=0)
    cfg = small_gnn_config("graphsage", batch_size=32, feat_dim=24,
                           num_classes=6, hidden_size=40,
                           num_hidden_layers=2, fanouts=(4, 5, 6),
                           hec=HECConfig(cache_size=4096, ways=4,
                                         push_limit=128))
    draw = default_push_uniforms(dev)
    plan = SamplingPlan(ps, cfg, 0)
    hosts = list(plan.batches(plan.epoch_schedule(0), 0))[:2]
    runs = []
    for d in (dev, torch.device("cpu")):
        tr = DistTrainer(cfg, 4, device=d,
                         push_uniforms=lambda s, r, sh: draw(s, r, sh).to(d))
        st = tr.init_state(seed=3)
        data = build_dist_data(ps, cfg, d)
        losses = [tr.train_step(st, data, minibatch_to_device(h, d), i)
                  ["loss"] for i, h in enumerate(hosts)]
        runs.append((losses, st))
    (l_gpu, s_gpu), (l_cpu, s_cpu) = runs
    assert np.allclose(l_gpu, l_cpu, rtol=1e-4, atol=1e-5)
    for a, b in zip(s_gpu["model"].parameter_list(),
                    s_cpu["model"].parameter_list()):
        assert close(a.detach().cpu(), b.detach())
    for la, lb in zip(s_gpu["hec"], s_cpu["hec"]):
        for a, b in zip(la, lb):
            assert torch.equal(a.tags.cpu(), b.tags)
    for a, b in zip(s_gpu["inflight"], s_cpu["inflight"]):
        assert torch.equal(a["tags"].cpu(), b["tags"])


def mode_run(d, mode, model):
    """Two steps of a 4-rank trainer in ``mode`` on device ``d`` (``aep``
    with the hot tier), then ``evaluate`` (its accuracy and the state
    before and after it): what the card tests of the modes compare."""
    from repro_torch.configs.gnn import HECConfig, small_gnn_config
    from repro_torch.graph import partition_graph, synthetic_graph
    from repro_torch.pipeline.prefetcher import SamplingPlan
    from repro_torch.train.gnn_trainer import (DistTrainer, build_dist_data,
                                               minibatch_to_device)
    g = synthetic_graph(num_vertices=2000, avg_degree=8, num_classes=6,
                        feat_dim=24, seed=0)
    ps = partition_graph(g, 4, seed=0)
    hot = dict(hot_size=48, hot_budget=32) if mode == "aep" else {}
    cfg = small_gnn_config(model, batch_size=32, feat_dim=24, num_classes=6,
                           hidden_size=16, num_hidden_layers=2,
                           fanouts=(4, 5, 6),
                           hec=HECConfig(cache_size=4096, ways=4,
                                         push_limit=128, **hot))
    plan = SamplingPlan(ps, cfg, 0)
    hosts = list(plan.batches(plan.epoch_schedule(0), 0))[:2]
    tr = DistTrainer(cfg, 4, mode=mode, device=d)
    data = build_dist_data(ps, cfg, d)
    st = tr.init_state(seed=3, dist_data=data)
    logs = [tr.train_step(st, data, minibatch_to_device(h, d), i)
            for i, h in enumerate(hosts)]
    out = {"logs": logs, "mu": [m.cpu().clone() for m in st["opt"].mu],
           "state": state_tensors(st)}
    out["acc"] = tr.evaluate(ps, data, st, num_batches=3)
    out["after"] = state_tensors(st)
    return out


def state_tensors(st):
    """Every tensor of a training state, as host copies."""
    out = [p.detach().cpu().clone() for p in st["model"].parameter_list()]
    out += [getattr(s, f).cpu().clone() for layer in st["hec"] for s in layer
            for f in ("tags", "age", "values")]
    out += [getattr(s, f).cpu().clone() for s in st["hot"]
            for f in ("age", "values")]
    out += [q[k].cpu().clone() for q in st["inflight"] for k in sorted(q)]
    return out


def bit_equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("mode", ["sync", "drop", "aep"])
@pytest.mark.parametrize("model", ["graphsage", "gat"])
def test_modes_on_card_match_cpu(dev, mode, model):
    """Two steps of ``sync``, ``drop`` and ``aep`` with the hot tier on the
    card == the same steps through the plain versions on the CPU: loss and
    gradient norm within 1e-4 relative, Adam's first moment within
    tolerance after step 1 for GraphSAGE, the counts equal, and HEC tags,
    hot-tier slot ages and every queued tag equal; ``evaluate`` on the
    card leaves the state bit-equal to what it was, and its accuracy is
    the CPU's within one eval example in fifty."""
    gpu, cpu = mode_run(dev, mode, model), mode_run(torch.device("cpu"),
                                                   mode, model)
    for a, b in zip(gpu["logs"], cpu["logs"]):
        assert set(a) == set(b)
        for k in ("loss", "grad_norm"):
            assert abs(a[k] - b[k]) <= 1e-4 * abs(b[k]), k
        for k in a:
            if k.startswith(("hec_hits", "hec_halos", "hot_", "aep_push_rows",
                             "exam")):
                assert a[k] == b[k], k
    if model == "graphsage":
        assert all(close(a, b) for a, b in zip(gpu["mu"], cpu["mu"]))
    ints = lambda xs: [x for x in xs if x.dtype != torch.float32]  # noqa
    assert bit_equal(ints(gpu["state"]), ints(cpu["state"]))
    assert bit_equal(gpu["after"], gpu["state"])
    assert abs(gpu["acc"] - cpu["acc"]) <= 0.02
    if mode == "sync":
        assert gpu["logs"][-1]["hec_hits_l0"] > 0
    if mode == "aep":
        assert gpu["logs"][-1]["hot_push_rows"] > 0


def test_sync_fetch_and_hot_segment_on_card_match_cpu(dev):
    """The sync fetch (fewer halos than slots on rank 0, more on the
    others) and the hot tier's selection, fused push and consume on the
    card: every output bit-equal to the CPU's."""
    from repro_torch.cache import hot_tier
    from repro_torch.comm import HaloExchangeEngine, StackedCollective
    rng = np.random.default_rng(4)
    R, N0, F, S, nc, K, dims = 4, 3000, 24, 700, 400, 48, [24, 16]
    svids = np.sort(rng.choice(10_000, (R, S), replace=False), 1)
    vid0 = rng.integers(-1, 10_000, (R, N0))
    vid0[:, :S // 2] = svids[(np.arange(R) + 1) % R][:, :S // 2]
    is_halo0 = (rng.random((R, N0)) < 0.5) & (vid0 >= 0)
    is_halo0[0, nc // 2:] = False
    hot = svids[:, :K // R].reshape(-1)
    order = np.argsort(hot)
    hot_owner = np.repeat(np.arange(R), K // R)[order]
    own_vid0 = np.full((R, N0), -1)
    own_vid0[:, :S] = svids
    cpu = torch.device("cpu")
    outs = []
    for d in (dev, cpu):
        t = lambda x, dt=torch.int32: torch.as_tensor(  # noqa: E731
            x, device=d).to(dt)
        eng = HaloExchangeEngine(R, 2, nc, 1, StackedCollective(R),
                                 hot_budget=16)
        h0, got = eng.sync_fetch(
            t(svids), t(np.tile(np.arange(S), (R, 1))),
            t(rng_features(R, S, F), torch.float32), t(vid0), t(is_halo0,
                                                                torch.bool),
            torch.zeros((R, N0, F), device=d))
        hot_vids = t(hot[order])
        captured = [(t(rng_features(1, N0, w)[0], torch.float32),
                     torch.ones(N0, dtype=torch.bool, device=d))
                    for w in dims]
        sels = [eng.select_hot_push(
            hot_vids, t(hot_owner == r, torch.bool), t(np.arange(N0)),
            torch.ones(N0, dtype=torch.bool, device=d), t(own_vid0[r]),
            t(S), captured, t(np.linspace(0.9, 0.1, N0), torch.float32),
            dims, max(dims)) for r in range(R)]
        empty = [(torch.full((R, 2, nc), -1, dtype=torch.int32, device=d),
                  torch.zeros((R, 2, nc, max(dims)), device=d))
                 for _ in range(R)]
        q, stats = eng.aep_push(empty, eng.inflight_init(max(dims), d), dims,
                                hot=sels)
        caches = [[hec.hec_init(64, 4, w, d) for w in dims] for _ in range(R)]
        tiers = [hot_tier.tier_init(K, w, d, num_ranks=R) for w in dims]
        for r in range(R):
            eng.consume_push(caches[r], q[r], dims, 2,
                             hot=[tt.rank(r) for tt in tiers])
        outs.append([x.cpu() for x in (h0, got, *sels[0], stats[
            "hot_push_rows"], q[1]["hot_tags"], *(tt.age for tt in tiers),
            *(tt.values for tt in tiers))])
    assert bit_equal(*outs)
    assert int(outs[0][1].sum()) > 0 and int((outs[0][2] >= 0).sum()) > 0
    # every rank owns 12 hot vertices (under the budget of 16) and sends
    # them all: every slot of every replica is refreshed
    assert bool((outs[0][6] == 0).all()) and bool((outs[0][7] == 0).all())


def rng_features(R, n, w, seed=5):
    return np.random.default_rng(seed + w).normal(
        size=(R, n, w)).astype(np.float32)


# ---------------------------------------------------------------------------
# GAT AGG (G, H)
# ---------------------------------------------------------------------------
GAT_SHAPES = [(80, 20, 4, 2, 8), (257, 61, 13, 3, 20), (300, 40, 7, 2, 6),
              (300, 40, 40, 4, 16), (20000, 4000, 5, 4, 256),
              (16000, 1000, 15, 1, 172), (100000, 2048, 77, 4, 256),
              (5000, 64, 15, 4, 256), (3000, 64, 15, 1, 172),
              (500, 30, 400, 4, 8), (500, 30, 400, 3, 6)]


def gat_inputs(dev, seed, N, M, f, H, dh, dst):
    """-1 pads, indices past N, an all-masked row, invalid sources and a
    score of exactly 0; ``dst``: clipped and repeated dst ids."""
    rng = np.random.default_rng(seed)
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    z = rng.normal(size=(N, H, dh)).astype(np.float32)
    eu = rng.normal(size=(N, H)).astype(np.float32)
    ev = rng.normal(size=(N, H)).astype(np.float32)
    nbr = rng.integers(-1, N + 3, (M, f)).astype(np.int32)
    nbr[0] = -1
    valid = rng.random(N) > 0.15
    nbr[1, 0] = np.flatnonzero(valid[:N - 1])[0]
    eu[nbr[1, 0], 0] = -ev[1, 0]
    d = None
    if dst:
        d = rng.integers(-2, N + 2, M).astype(np.int32)
        d[:3] = [-1, 5, 5]
    return dict(z=t(z), e_u=t(eu), e_v=t(ev), nbr_idx=t(nbr),
                src_valid=t(valid), dst_idx=None if d is None else t(d))


@pytest.mark.parametrize("N,M,f,H,dh", GAT_SHAPES)
@pytest.mark.parametrize("dst", [False, True])
def test_gat_kernels_match_plain(dev, N, M, f, H, dh, dst):
    kw = gat_inputs(dev, N + f + H, N, M, f, H, dh, dst)
    before = (gat_edge.gat_edge_fwd.launches, gat_edge.gat_edge_bwd.launches)
    out = gat_edge.gat_edge_fwd(**kw)
    want = ref.gat_edge_ref(**kw)
    torch.cuda.synchronize()
    assert close(out, want)
    assert float(out[0].abs().max()) == 0.0
    g = torch.randn(M, H * dh, device=dev)
    got = gat_edge.gat_edge_bwd(g, **kw)
    plain = ref.gat_edge_bwd_ref(g, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, plain):
        assert a.shape == b.shape and close(a, b)
    assert (gat_edge.gat_edge_fwd.launches, gat_edge.gat_edge_bwd.launches) \
        == (before[0] + 1, before[1] + 1)


def test_gat_fwd_takes_every_form(dev):
    """Kernel G's forms at GAT_SHAPES: a warp per row, a warp per column
    part at serving-sized M (64 rows of 4 x 256 or 1 x 172), and the
    chunked form for 400 slots of 4 heads."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    routes = {(M, f, H, dh): gat_edge.fwd_plan(M, f, H, dh, dh % 4 == 0,
                                               sms)[0]
              for _, M, f, H, dh in GAT_SHAPES}
    assert routes[(64, 15, 4, 256)] == routes[(64, 15, 1, 172)] == "split"
    assert routes[(30, 400, 4, 8)] == "chunked"
    assert set(routes.values()) == {"row", "split", "chunked"}


def test_gat_autograd_on_card_matches_cpu(dev):
    """A GAT layer (projection, logits, kernels G and H) differentiated on
    the card and on the CPU: the same output and parameter gradients."""
    from repro_torch.models.gnn.gat import GATLayer
    rng = np.random.default_rng(8)
    N, M, f, din, H, dh = 700, 150, 9, 48, 4, 16
    h = rng.normal(size=(N, din)).astype(np.float32)
    nbr = rng.integers(-1, N, (M, f)).astype(np.int32)
    valid = rng.random(N) > 0.1
    res = []
    for d in (dev, torch.device("cpu")):
        torch.manual_seed(0)
        layer = GATLayer(din, H, dh)
        with torch.no_grad():
            for p in layer.parameters():
                p.copy_(torch.randn(p.shape) * 0.2)
        layer = layer.to(d)
        out = layer(torch.as_tensor(h, device=d),
                    torch.as_tensor(nbr, device=d),
                    torch.as_tensor(valid, device=d))
        grads = torch.autograd.grad((out * out).sum(),
                                    list(layer.parameters()))
        res.append([out] + list(grads))
    for a, b in zip(*res):
        assert close(a.detach().cpu(), b.detach())


def test_gat_training_steps_on_card_match_cpu(dev):
    """Two aep steps of a 4-rank GAT through kernels G, H and B == the same
    steps through the plain versions: loss and gradient norm within 1e-4
    relative, the first step's gradients (Adam's first moment) within
    tolerance, HEC tags and pushed tags equal.  (After a step, entries
    whose gradient is at float-noise level have moved by Adam's full step
    of either sign on each device, so later gradients are compared
    through the loss only.)"""
    from repro_torch.configs.gnn import HECConfig, small_gnn_config
    from repro_torch.graph import partition_graph, synthetic_graph
    from repro_torch.pipeline.prefetcher import SamplingPlan
    from repro_torch.train.gnn_trainer import (DistTrainer, build_dist_data,
                                               default_push_uniforms,
                                               minibatch_to_device)
    g = synthetic_graph(num_vertices=2000, avg_degree=8, num_classes=6,
                        feat_dim=24, seed=0)
    ps = partition_graph(g, 4, seed=0)
    cfg = small_gnn_config("gat", batch_size=32, feat_dim=24, num_classes=6,
                           hidden_size=16, num_hidden_layers=2,
                           fanouts=(4, 5, 6),
                           hec=HECConfig(cache_size=4096, ways=4,
                                         push_limit=128))
    draw = default_push_uniforms(dev)
    plan = SamplingPlan(ps, cfg, 0)
    hosts = list(plan.batches(plan.epoch_schedule(0), 0))[:2]
    runs = []
    for d in (dev, torch.device("cpu")):
        tr = DistTrainer(cfg, 4, device=d,
                         push_uniforms=lambda s, r, sh: draw(s, r, sh).to(d))
        st = tr.init_state(seed=3)
        data = build_dist_data(ps, cfg, d)
        logs = []
        for i, h in enumerate(hosts):
            logs.append(tr.train_step(st, data, minibatch_to_device(h, d), i))
            if i == 0:
                mu = [m.cpu().clone() for m in st["opt"].mu]
        runs.append((logs, mu, st))
    (l_gpu, mu_gpu, s_gpu), (l_cpu, mu_cpu, s_cpu) = runs
    for a, b in zip(l_gpu, l_cpu):
        for k in ("loss", "grad_norm"):
            assert abs(a[k] - b[k]) <= 1e-4 * abs(b[k]), k
        for k in a:
            if k.startswith(("hec_hits", "hec_halos", "aep_push")):
                assert a[k] == b[k], k
    for a, b in zip(mu_gpu, mu_cpu):
        assert close(a, b)
    for la, lb in zip(s_gpu["hec"], s_cpu["hec"]):
        for a, b in zip(la, lb):
            assert torch.equal(a.tags.cpu(), b.tags)
    for a, b in zip(s_gpu["inflight"], s_cpu["inflight"]):
        assert torch.equal(a["tags"].cpu(), b["tags"])


# ---------------------------------------------------------------------------
# AGG gradient past the last row (F), fanout draw (I)
# ---------------------------------------------------------------------------
def test_agg_gradient_drops_out_of_range_indices(dev):
    """Kernel F, as its plain version, adds nothing for an index past the
    last row; the forward (E) reads the last row for it."""
    rng = np.random.default_rng(8)
    N, M, f, D = 500, 64, 6, 36
    nbr = rng.integers(-1, N + 4, (M, f)).astype(np.int32)
    nbr[2] = N + 1                                 # only past the end
    valid = rng.random(N) > 0.15
    valid[N - 1] = True
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    h = t(rng.normal(size=(N, D)).astype(np.float32))
    mean, cnt = sage_agg.sage_agg_fwd(h, t(nbr), t(valid))
    mean_p, cnt_p = ref.sage_agg_ref(h, t(nbr), t(valid))
    assert close(mean, mean_p) and torch.equal(cnt, cnt_p)
    assert float(cnt[2]) == f
    g = t(rng.normal(size=(M, D)).astype(np.float32))
    dh = sage_agg.sage_agg_bwd(g, t(nbr), t(valid), cnt, N)
    dh_p = ref.sage_agg_bwd_ref(g, t(nbr), t(valid), cnt_p, N)
    torch.cuda.synchronize()
    assert close(dh, dh_p)
    inside = torch.as_tensor(nbr, device=dev).clone()
    inside[inside >= N] = -1                       # what the gradient sees
    assert close(dh, ref.sage_agg_bwd_ref(g, inside, t(valid), cnt_p, N))


def ragged_csr(rng, S, H, max_deg):
    """A CSR of S solids over S + H VID_p with degrees 0..max_deg, a row of
    each of 0, 1, 3 and 4 neighbors and a row listing one vertex 5 times."""
    deg = rng.integers(0, max_deg + 1, S)
    deg[:5] = [0, 1, 3, 4, 9]
    rows = [rng.integers(0, S + H, d) for d in deg]
    rows[4] = np.array([7, S + 1, 7, 7, 12, 7, 3, 7, 30])
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    return indptr, np.concatenate(rows).astype(np.int32)


def draw_pair(dev, indptr, indices, wtab, cur, seed, allow, f, S, policy):
    """Kernel I and its plain version on the same inputs, on the card."""
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    width = max(int(np.diff(indptr).max()), 1)
    args = (t(indptr), t(indices), t(wtab), t(cur.astype(np.int32)), seed,
            None if allow is None else t(allow))
    kw = dict(f=f, num_solid=S, width=width, policy=policy)
    before = sample_draw.sample_draw.launches
    got = sample_draw.sample_draw(*args, **kw)
    want = ref.draw_neighbors(*args, **kw)
    torch.cuda.synchronize()
    assert sample_draw.sample_draw.launches == before + 1
    return got, want


@pytest.mark.parametrize("policy", ["uniform", "labor", "cv"])
@pytest.mark.parametrize("S,H,max_deg,n,f", [
    (40, 10, 70, 77, 3), (40, 10, 2, 77, 4), (3000, 500, 300, 16000, 10),
    (20000, 4000, 40, 176000, 5), (500, 0, 600, 1000, 15)])
def test_sample_draw_kernel_bitmatches_plain(dev, policy, S, H, max_deg, n,
                                             f):
    """-1 rows, halos, allow=False rows, deg == f and deg < f, a multi-edge
    row, width < f (the second shape), n off a multiple of 32, rows wider
    than a warp's 32 slots, and the seed's top bit set."""
    rng = np.random.default_rng(S + n + f)
    indptr, indices = ragged_csr(rng, S, H, max_deg)
    cur = rng.integers(-1, S + H, n)
    cur[:6] = [-1, S, 0, 1, 2, 4]
    allow = rng.random(n) > 0.1
    wtab = (1.0 + 4.0 * (rng.random(S + H) < 0.3)).astype(np.float32)
    for a in (allow, None):
        got, want = draw_pair(dev, indptr, indices, wtab, cur, 0xF00DCAFE,
                              a, f, S, policy)
        assert got.dtype == torch.int32 and got.shape == (n, f)
        assert torch.equal(got, want)


def degree_csr(rng, degrees, S, H):
    """A CSR of S solids over S + H VID_p whose rows take the given
    degrees in turn; every fourth row lists its first vertex twice more
    (a multi-edge: its labor and cv keys tie)."""
    deg = np.resize(np.asarray(degrees), S)
    rows = []
    for i, d in enumerate(deg):
        row = rng.integers(0, S + H, d)
        if i % 4 == 3 and d >= 3:
            row[1:3] = row[0]
        rows.append(row)
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    return indptr, np.concatenate(rows).astype(np.int32)


DRAW_DEGREES = [0, 1, 2, 4, 5, 8, 9, 15, 16, 17, 31, 32, 33, 64, 65, 128,
                129, 600]


@pytest.mark.parametrize("policy", ["uniform", "labor", "cv"])
@pytest.mark.parametrize("f", [1, 16, 17, 32])
@pytest.mark.parametrize("group", sample_draw.GROUPS)
def test_sample_draw_kernel_every_degree(dev, policy, f, group, monkeypatch):
    """I at every tile size, bit for bit: tiles that mix take-all and
    selection rows of every degree class (1, 2 and 4 candidates a lane,
    so rows of 32, 33, 64, 65, 128 and 129 slots; 600 by rounds), 64 rows
    that draw nothing (-1, halos, allow=False), n = 1, multi-edges whose
    labor and cv keys tie, and a seed with its top bit set."""
    monkeypatch.setattr(sample_draw, "draw_group", lambda n, sms: group)
    rng = np.random.default_rng(f + group)
    S, H = 900, 100
    indptr, indices = degree_csr(rng, DRAW_DEGREES, S, H)
    wtab = (1.0 + 4.0 * (rng.random(S + H) < 0.3)).astype(np.float32)
    mixed = rng.permutation(384)               # every degree, 12 tiles of 32
    nothing = np.concatenate([np.full(20, -1), rng.integers(S, S + H, 24),
                              rng.integers(0, S, 20)])
    cur = np.concatenate([mixed, nothing, mixed[:37]])
    allow = np.ones(cur.shape[0], bool)
    allow[384 + 44:384 + 64] = False            # the solid rows of `nothing`
    allow[-37::5] = False
    for c, a in ((cur, allow), (cur, None), (cur[:1], None)):
        got, want = draw_pair(dev, indptr, indices, wtab, c, 0x9E3779B9, a,
                              f, S, policy)
        assert torch.equal(got, want)
        if a is not None:
            assert bool((got[384:448] == -1).all())


def test_device_sampler_on_card_matches_cpu(dev):
    """``DeviceSampler`` on the card (its own stream, pinned copies) ==
    on the CPU, with a residency, from four threads at once."""
    import concurrent.futures

    from repro_torch.graph import partition_graph, synthetic_graph
    from repro_torch.pipeline.vectorized_sampler import DeviceSampler
    g = synthetic_graph(num_vertices=3000, avg_degree=8, seed=1)
    part = partition_graph(g, 2, seed=0).parts[1]
    rng = np.random.default_rng(4)
    mask = rng.random(part.num_solid + part.num_halo) < 0.3
    samplers = {}
    for d in (dev, "cpu"):
        samplers[str(d)] = DeviceSampler(part, base_seed=5, rank=1,
                                         policy="cv", device=d)
        samplers[str(d)].set_residency(mask)
    curs = [rng.integers(-1, part.num_solid + part.num_halo, 3000)
            for _ in range(8)]
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        card = list(pool.map(lambda i: samplers[str(dev)].draw(
            0, i, 2, curs[i], 7), range(8)))
    for i in range(8):
        assert np.array_equal(card[i], samplers["cpu"].draw(0, i, 2, curs[i],
                                                            7))


def test_device_draw_minibatches_on_card_match_cpu(dev):
    """``SamplingPlan`` with ``device_draw`` (cv, a residency installed) on
    the card and on the CPU: every ``stack_ranks`` array equal, through 3
    prefetch workers; 3 launches of I per rank and step."""
    from repro_torch.configs.gnn import (PipelineConfig, SamplerConfig,
                                         small_gnn_config)
    from repro_torch.graph import partition_graph, synthetic_graph
    from repro_torch.pipeline.prefetcher import SamplingPlan
    g = synthetic_graph(num_vertices=4000, avg_degree=8, seed=0)
    ps = partition_graph(g, 4, seed=0)
    cfg = small_gnn_config(
        "graphsage", batch_size=32, num_hidden_layers=2, fanouts=(4, 5, 6),
        pipeline=PipelineConfig(num_workers=3, prefetch_depth=2,
                                sampler=SamplerConfig(policy="cv",
                                                      device_draw=True)))
    rng = np.random.default_rng(1)
    masks = [rng.random(p.num_solid + p.num_halo) < 0.3 for p in ps.parts]
    out = []
    for d in (dev, "cpu"):
        plan = SamplingPlan(ps, cfg, 0, device=d)
        plan.set_cv_residency(masks)
        before = sample_draw.sample_draw.launches
        out.append(list(plan.batches(plan.epoch_schedule(0), 0)))
        launches = sample_draw.sample_draw.launches - before
    card, cpu = out
    assert len(card) == len(cpu) > 1
    for a, b in zip(card, cpu):
        for k in a:
            for x, y in (zip(a[k], b[k]) if isinstance(a[k], list)
                         else [(a[k], b[k])]):
                assert np.array_equal(x, y), k
    assert launches == 0                   # the CPU plan ran the plain draw
    # ...and the card's: 3 layers x 4 ranks per step
    plan = SamplingPlan(ps, cfg, 0, device=dev)
    before = sample_draw.sample_draw.launches
    plan.sample_host(0, 0, plan.epoch_schedule(0)[0])
    assert sample_draw.sample_draw.launches - before == 12


# ---------------------------------------------------------------------------
# the pipeline's staging, the push on its side stream, the device trace
# ---------------------------------------------------------------------------
def small_pipeline_setup(R=4, batch=16, **pipe):
    from repro_torch.configs.gnn import (HECConfig, PipelineConfig,
                                         small_gnn_config)
    from repro_torch.graph import partition_graph, synthetic_graph
    g = synthetic_graph(num_vertices=2000, avg_degree=8, num_classes=6,
                        feat_dim=24, seed=0)
    ps = partition_graph(g, R, seed=0)
    cfg = small_gnn_config("graphsage", batch_size=batch, feat_dim=24,
                           num_classes=6, hidden_size=40,
                           num_hidden_layers=2, fanouts=(4, 5, 6),
                           hec=HECConfig(cache_size=4096, ways=4,
                                         push_limit=128),
                           pipeline=PipelineConfig(**pipe))
    return ps, cfg


@pytest.mark.parametrize("double_buffer", [True, False])
def test_staging_survives_overwritten_pinned_host(dev, double_buffer):
    """``device_stage`` on the card: the staged batches equal the host
    ones, in order, though the test overwrites every pinned host buffer
    right after each yield; and an unpinned host batch is refused."""
    from repro_torch.pipeline.prefetcher import SamplingPlan
    from repro_torch.pipeline.staging import device_stage
    ps, cfg = small_pipeline_setup()
    plan = SamplingPlan(ps, cfg, 0, pin_memory=True)
    sched = plan.epoch_schedule(0)
    assert len(sched) >= 3
    hosts = [plan.sample_host(0, i, sched[i]) for i in range(3)]
    want = [{k: [a.clone() for a in v] if isinstance(v, list) else v.clone()
             for k, v in h.items()} for h in hosts]
    assert all(a.is_pinned() for h in hosts for v in h.values()
               for a in (v if isinstance(v, list) else [v]))
    got = []
    for mb in device_stage(iter(hosts), double_buffer, device=dev):
        got.append(mb)
        for v in hosts[len(got) - 1].values():
            for a in (v if isinstance(v, list) else [v]):
                a.fill_(True if a.dtype == torch.bool else -7)
    torch.cuda.synchronize()
    assert len(got) == 3
    for mb, w in zip(got, want):
        for k in w:
            for x, y in (zip(mb[k], w[k]) if isinstance(w[k], list)
                         else [(mb[k], w[k])]):
                assert x.is_cuda and torch.equal(x.cpu(), y), k
    unpinned = SamplingPlan(ps, cfg, 0).sample_host(0, 0, sched[0])
    with pytest.raises(ValueError, match="pinned"):
        list(device_stage(iter([unpinned]), double_buffer, device=dev))


def test_side_stream_push_matches_inline_push(dev, monkeypatch):
    """Three steps through ``MinibatchPipeline`` with the push on its side
    stream and inline after the backward: HEC tags and ages, queued tags
    and pushed rows equal, losses within 1e-4 relative; kernels D and F
    launch only on the main stream, so D's ticket is never shared with
    the push stream."""
    from repro_torch.kernels import sage_agg as sa
    from repro_torch.pipeline.staging import MinibatchPipeline
    from repro_torch.train.gnn_trainer import DistTrainer, build_dist_data
    ps, cfg = small_pipeline_setup()
    streams = []
    for mod, name in ((update_fused, "update_fused_bwd"),
                      (sa, "sage_agg_bwd")):
        inner = getattr(mod, name)

        def spy(*a, _inner=inner, **kw):
            streams.append(torch.cuda.current_stream().cuda_stream)
            return _inner(*a, **kw)
        spy.launches = 0               # the wrapper counts on its name
        monkeypatch.setattr(mod, name, spy)
    runs = []
    for overlap in (True, False):
        tr = DistTrainer(cfg, 4, device=dev, overlap=overlap)
        assert (tr.push_stream is not None) == overlap
        st = tr.init_state(seed=3)
        data = build_dist_data(ps, cfg, dev)
        pipe = MinibatchPipeline(ps, cfg, 0, device=dev)
        logs = [tr.train_step(st, data, mb, i)
                for i, mb in zip(range(3), pipe.epoch_batches(0))]
        tr.join_push()
        torch.cuda.synchronize()
        runs.append((logs, st))
        main = torch.cuda.current_stream().cuda_stream
        assert streams and set(streams) == {main}
        if overlap:
            assert tr.push_stream.cuda_stream != main
        streams.clear()
    (la, sa_), (lb, sb) = runs
    for a, b in zip(la, lb):
        assert a["aep_push_rows"] == b["aep_push_rows"] > 0
        assert abs(a["loss"] - b["loss"]) <= 1e-4 * abs(b["loss"])
    for x, y in zip(sa_["hec"], sb["hec"]):
        for a, b in zip(x, y):
            assert torch.equal(a.tags, b.tags) and torch.equal(a.age, b.age)
    for a, b in zip(sa_["inflight"], sb["inflight"]):
        assert torch.equal(a["tags"], b["tags"])


def test_two_stream_trace_busy_share_at_most_one(dev):
    """A ``DeviceTrace`` of matmuls on two streams at once: two device
    tracks, and the busy share (the union of their intervals) <= 1 while
    the streams' own times may add up to more."""
    from repro_torch import obs
    tracer = obs.Tracer(enabled=True)
    a = torch.randn(2048, 2048, device=dev)
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    with obs.DeviceTrace(dev, tracer) as dt:
        for _ in range(4):
            for s in (s1, s2):
                with torch.cuda.stream(s):
                    for _ in range(8):
                        a @ a
    torch.cuda.synchronize()
    summary = dt.summary()
    assert len(summary["streams"]) >= 2
    assert 0.0 < summary["busy_share"] <= 1.0
    assert summary["busy_us"] <= summary["wall_us"]
    trace = tracer.export()
    assert obs.validate_chrome_trace(trace) == len(dt.events) > 0
    assert obs.busy_us(obs.device_events(trace)) == pytest.approx(
        obs.busy_us(dt.events))


# ---------------------------------------------------------------------------
# fixed-order gradients (F, H): the same bits on every launch and run
# ---------------------------------------------------------------------------
def hub_nbr(rng, N, M, f, hub=7, hub_slots=4500):
    """Collision-heavy slots: one source row that more than 4,096 slots
    point at, a second of CHUNK + 1, -1 pads and indices past N."""
    nbr = rng.integers(-1, N + 3, (M, f)).astype(np.int32)
    flat = nbr.reshape(-1)
    pick = rng.choice(flat.size, hub_slots + slot_index.CHUNK + 1,
                      replace=False)
    flat[pick[:hub_slots]] = hub
    flat[pick[hub_slots:]] = hub + 1
    return nbr


def inflated(ix, by=3):
    """The same index with a larger bound on long chunks: another grid."""
    return slot_index.SlotIndex(ix.offsets, ix.slots, ix.lbase, ix.num_src,
                                ix.lbound * by + 5)


@pytest.mark.parametrize("N,M,f,D", [(3000, 2000, 5, 256), (900, 1200, 7, 6),
                                     (176000, 16000, 10, 256)])
def test_agg_gradient_fixed_order(dev, N, M, f, D):
    """F on a hub of > 4,096 slots, -1 and >= N slots: three launches and a
    larger grid give the same bits; within tolerance of the plain version
    in float64 (a float32 sum of thousands of terms parts from the exact
    one by ~1e-4 in any order), and the float32 plain version's bits on
    every row of at most CHUNK slots."""
    rng = np.random.default_rng(N + f)
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    nbr = t(hub_nbr(rng, N, M, f))
    valid = rng.random(N) > 0.15
    valid[[7, 8]] = True
    valid = t(valid)
    _, cnt = sage_agg.sage_agg_fwd(t(rng.normal(size=(N, D)).astype(
        np.float32)), nbr, valid)
    g = t(rng.normal(size=(M, D)).astype(np.float32))
    ix = slot_index.slot_index(nbr, valid, N)
    runs = [sage_agg.sage_agg_bwd(g, nbr, valid, cnt, N, ix) for _ in range(3)]
    runs.append(sage_agg.sage_agg_bwd(g, nbr, valid, cnt, N, inflated(ix)))
    runs.append(sage_agg.sage_agg_bwd(g, nbr, valid, cnt, N))
    torch.cuda.synchronize()
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    plain = ref.sage_agg_bwd_ref(g.cpu(), nbr.cpu(), valid.cpu(), cnt.cpu(),
                                 N)
    got = runs[0].cpu()
    assert close(got.double(), ref.sage_agg_bwd_ref(
        g.cpu().double(), nbr.cpu(), valid.cpu(), cnt.cpu().double(), N))
    lens = (ix.offsets[1:] - ix.offsets[:-1]).cpu()
    short = lens <= slot_index.CHUNK
    assert bool((lens > 4096).any()) and bool(short.any())
    assert torch.equal(got[short], plain[short])


@pytest.mark.parametrize("N,M,f,H,dh", [(3000, 2000, 5, 4, 256),
                                        (1300, 1200, 7, 1, 172),
                                        (800, 700, 9, 3, 6)])
@pytest.mark.parametrize("dst", [False, True])
def test_gat_gradient_fixed_order(dev, N, M, f, H, dh, dst):
    """H (both passes) on a hub of > 4,096 slots, -1 and >= N slots, with
    and without dst: three launches and a larger grid give the same bits,
    within tolerance of the plain version in float64 (as F's test)."""
    kw = gat_inputs(dev, N + f + H, N, M, f, H, dh, dst)
    rng = np.random.default_rng(N + H)
    kw["nbr_idx"] = torch.as_tensor(hub_nbr(rng, N, M, f), device=dev)
    kw["src_valid"][[7, 8]] = True
    g = torch.randn(M, H * dh, device=dev)
    ix = slot_index.slot_index(kw["nbr_idx"], kw["src_valid"], N)
    runs = [gat_edge.gat_edge_bwd(g, **kw, index=ix) for _ in range(3)]
    runs.append(gat_edge.gat_edge_bwd(g, **kw, index=inflated(ix)))
    runs.append(gat_edge.gat_edge_bwd(g, **kw))
    torch.cuda.synchronize()
    for r in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], r))
    wide = {k: (v.double() if k in ("z", "e_u", "e_v") else v)
            for k, v in kw.items()}
    plain = ref.gat_edge_bwd_ref(g.double(), **wide)
    for a, b in zip(runs[0], plain):
        assert a.shape == b.shape and close(a.double(), b)


def test_slot_index_on_card_equals_cpu(dev):
    """The index build gives the CPU's integers on the card."""
    rng = np.random.default_rng(4)
    N, M, f = 5000, 3000, 6
    nbr = hub_nbr(rng, N, M, f)
    valid = rng.random(N) > 0.2
    a = slot_index.slot_index(torch.as_tensor(nbr, device=dev),
                              torch.as_tensor(valid, device=dev), N)
    b = slot_index.slot_index(torch.as_tensor(nbr), torch.as_tensor(valid),
                              N)
    for k in ("offsets", "slots", "lbase"):
        assert torch.equal(getattr(a, k).cpu(), getattr(b, k)), k
    assert a.lbound == b.lbound


def repeat_run(dev, model, steps=3, plane=None):
    """``steps`` aep steps of a 4-rank trainer on the card from seed 3
    (``plane``: its resilience plane): the step metrics and every tensor
    of the state after them."""
    from repro_torch.configs.gnn import HECConfig, small_gnn_config
    from repro_torch.graph import partition_graph, synthetic_graph
    from repro_torch.pipeline.prefetcher import SamplingPlan
    from repro_torch.train.gnn_trainer import (DistTrainer, build_dist_data,
                                               minibatch_to_device)
    g = synthetic_graph(num_vertices=3000, avg_degree=10, num_classes=6,
                        feat_dim=24, seed=0)
    ps = partition_graph(g, 4, seed=0)
    cfg = small_gnn_config(model, batch_size=64, feat_dim=24, num_classes=6,
                           hidden_size=32, num_hidden_layers=2,
                           fanouts=(4, 5, 6),
                           hec=HECConfig(cache_size=4096, ways=4,
                                         push_limit=128))
    plan = SamplingPlan(ps, cfg, 0)
    hosts = list(plan.batches(plan.epoch_schedule(0), 0))[:steps]
    tr = DistTrainer(cfg, 4, device=dev, resilience=plane)
    data = build_dist_data(ps, cfg, dev)
    st = tr.init_state(seed=3, dist_data=data)
    logs = [tr.train_step(st, data, minibatch_to_device(h, dev), i)
            for i, h in enumerate(hosts)]
    tr.join_push()
    torch.cuda.synchronize()
    return logs, state_tensors(st)


@pytest.mark.parametrize("model", ["graphsage", "gat"])
def test_training_repeats_bit_for_bit(dev, model):
    """Two card trainings of 3 steps from the same state and minibatches
    give the same bits: every metric, parameter, HEC tag, age and value,
    and every queued row."""
    la, sa_ = repeat_run(dev, model)
    lb, sb = repeat_run(dev, model)
    assert la == lb
    assert bit_equal(sa_, sb)


@pytest.mark.parametrize("model", ["graphsage", "gat"])
def test_step_under_deterministic_algorithms(dev, model, monkeypatch):
    """A training step with torch.use_deterministic_algorithms(True) raises
    nothing: no op on the step's path is one that torch knows to be
    order-dependent on the card (cuBLAS's workspace set as it asks)."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        logs, _ = repeat_run(dev, model, steps=1)
    finally:
        torch.use_deterministic_algorithms(False)
    assert np.isfinite(logs[0]["loss"])


# ---------------------------------------------------------------------------
# NaN through the kernels: C, A, E, G and H give NaN where their plain
# versions do (the resilience plane's faults feed them NaN on purpose)
# ---------------------------------------------------------------------------
def nan_close(got, want):
    """NaN and +-inf exactly where ``want`` has them; ``close`` elsewhere."""
    fin = torch.isfinite(want)
    return (torch.equal(torch.isnan(got), torch.isnan(want))
            and torch.equal(got[torch.isinf(want)], want[torch.isinf(want)])
            and bool(torch.isfinite(got[fin]).all())
            and close(got[fin], want[fin]))


def poison_rows(t, rows, value=float("nan")):
    t = t.clone()
    t[rows] = value
    return t


@pytest.mark.parametrize("N,C,K", [(300, 96, 130), (1000, 256, 172),
                                   (17001, 256, 256)])
@pytest.mark.parametrize("relu,dropout", [(True, 0.0), (True, 0.5),
                                          (False, 0.0)])
def test_update_fwd_keeps_nan(dev, N, C, K, relu, dropout):
    """Kernel C on NaN rows of agg and of self (and one NaN element): NaN
    exactly where the plain version has it (ReLU and the dropout's kept
    positions keep it); a zero row with a -0.0 bias gives the plain
    version's zero bits; dZ (NaN > 0 is false) bit for bit."""
    kw = update_inputs(dev, N + C, N, C, K)
    kw["agg"] = poison_rows(kw["agg"], [0, 7, N - 1])
    kw["self_h"] = poison_rows(kw["self_h"], [3, 7])
    kw["agg"][11, 5] = float("nan")
    kw["agg"][12] = 0.0
    kw["self_h"][12] = 0.0
    kw["b"][:8] = -0.0
    out = update_fused.update_fused_fwd(relu=relu, dropout=dropout, seed=9,
                                        **kw)
    want = ref.fused_update_ref(relu=relu, dropout=dropout, seed=9, **kw)
    torch.cuda.synchronize()
    assert nan_close(out, want)
    assert bool(torch.isnan(want[[0, 3, 7, 11, N - 1]]).any(1).all())
    assert torch.equal(torch.signbit(out[12]), torch.signbit(want[12]))
    g = torch.randn(N, K, device=dev)
    dz, _ = update_fused.update_fused_bwd(g, want, relu=relu,
                                          dropout=dropout, seed=9)
    dz_p, _ = ref.fused_update_bwd_ref(g, want, relu=relu, dropout=dropout,
                                       seed=9)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(dz), torch.isnan(dz_p))
    assert torch.equal(dz.nan_to_num(), dz_p.nan_to_num())


@pytest.mark.parametrize("N,M,f,D,K", [(300, 37, 7, 24, 47),
                                       (2000, 512, 10, 256, 172),
                                       (67584, 11264, 5, 128, 256),
                                       (10000, 2048, 12, 128, 130)])
@pytest.mark.parametrize("self_idx", [False, True])
def test_serve_kernel_keeps_nan(dev, N, M, f, D, K, self_idx):
    """Kernel A on NaN rows of h (row 0, which every pad reads, among
    them; valid and invalid sources): NaN rows exactly where the plain
    version has them, ``close`` elsewhere, with and without ReLU."""
    kw = serve_inputs(dev, N + f, N, M, f, D, K, self_idx)
    valid = kw["src_valid"].cpu().numpy()
    rows = [0, int(np.flatnonzero(valid)[3]), int(np.flatnonzero(~valid)[2])]
    kw["h_src"] = poison_rows(kw["h_src"], rows)
    for relu in (True, False):
        got = serve_fused.serve_fused_layer(relu=relu, **kw)
        want = ref.serve_layer_ref(relu=relu, **kw)
        torch.cuda.synchronize()
        assert nan_close(got, want)
        assert bool(torch.isnan(want[1]).all())     # row 1: pads only


@pytest.mark.parametrize("N,M,f,D", AGG_SHAPES)
@pytest.mark.parametrize("row0", [float("nan"), 1.0])
def test_agg_fwd_keeps_nan(dev, N, M, f, D, row0):
    """Kernel E on NaN and +-inf rows of valid and of invalid sources:
    an excluded slot adds its row times 0, as the plain version's h * mask
    does, so the non-finite values and their positions are the plain
    version's; the counts bit for bit.  ``row0``: every pad reads row 0."""
    rng = np.random.default_rng(N + 2 * D)
    nbr = rng.integers(-1, N, (M, f)).astype(np.int32)
    nbr[0] = -1
    valid = rng.random(N) > 0.15
    h = rng.normal(size=(N, D)).astype(np.float32)
    h[np.flatnonzero(valid)[1:3]] = np.nan
    h[np.flatnonzero(~valid)[:2]] = np.nan
    h[np.flatnonzero(valid)[4], 0] = np.inf
    h[np.flatnonzero(~valid)[3], -1] = -np.inf
    h[0] = row0
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    mean, cnt = sage_agg.sage_agg_fwd(t(h), t(nbr), t(valid))
    mean_p, cnt_p = ref.sage_agg_ref(t(h), t(nbr), t(valid))
    torch.cuda.synchronize()
    assert nan_close(mean, mean_p) and torch.equal(cnt, cnt_p)
    assert bool(torch.isnan(mean_p).any())
    assert bool(torch.isnan(mean[0]).all()) == (row0 != row0)


@pytest.mark.parametrize("N,M,f,H,dh", GAT_SHAPES)
@pytest.mark.parametrize("dst", [False, True])
def test_gat_kernels_keep_nan(dev, N, M, f, H, dh, dst):
    """Kernel G on NaN rows of z and e_u (valid and invalid sources, row 0
    among them) and a NaN in e_v: the softmax's max and floor keep a NaN,
    an excluded slot adds its row times an alpha of 0, so NaN lies where
    the plain version's is.  Kernel H on a fanout whose every slot is
    included, with NaN rows in z and e_u and a NaN row and element in g:
    its NaN is the plain version's.  (Masked slots under a non-finite g:
    ``test_gat_bwd_keeps_nonfinite``.)"""
    kw = gat_inputs(dev, N + f + H + 1, N, M, f, H, dh, dst)
    valid = kw["src_valid"].cpu().numpy()
    bad = [0, int(np.flatnonzero(valid)[5]), int(np.flatnonzero(~valid)[1])]
    kw["z"] = poison_rows(kw["z"], bad)
    kw["e_u"] = poison_rows(kw["e_u"], [int(np.flatnonzero(valid)[9])])
    kw["e_v"][min(4, kw["e_v"].shape[0] - 1), 0] = float("nan")
    out = gat_edge.gat_edge_fwd(**kw)
    want = ref.gat_edge_ref(**kw)
    torch.cuda.synchronize()
    assert nan_close(out, want)
    assert bool(torch.isnan(want).any())
    rng = np.random.default_rng(M + f)
    full = dict(kw, src_valid=torch.ones_like(kw["src_valid"]),
                nbr_idx=torch.as_tensor(rng.integers(0, N, (M, f)).astype(
                    np.int32), device=dev))
    g = torch.randn(M, H * dh, device=dev)
    g[2] = float("nan")
    g[min(5, M - 1), -1] = float("nan")
    out = gat_edge.gat_edge_fwd(**full)
    want = ref.gat_edge_ref(**full)
    got = gat_edge.gat_edge_bwd(g, **full)
    plain = ref.gat_edge_bwd_ref(g, **full)
    torch.cuda.synchronize()
    assert nan_close(out, want)
    for a, b in zip(got, plain):
        assert a.shape == b.shape and nan_close(a, b)


def nonfinite_tensors(dev, case):
    return {k: torch.as_tensor(v, device=dev) for k, v in case.items()}


@pytest.mark.parametrize("N,M,f,D", [(100, 30, 5, 32), (333, 64, 9, 64),
                                     (300, 37, 7, 6), (2000, 600, 40, 130),
                                     (176000, 16000, 10, 256)])
def test_agg_bwd_keeps_nonfinite(dev, N, M, f, D):
    """Kernel F on a g with NaN and +-inf rows and elements at a row of
    pads only, of masked sources only, of indices past N only, and at rows
    with kept and masked slots: a masked slot inside [0, N) adds 0 * g at
    its row, as the plain version (and the reference's autodiff) does, so
    NaN and inf lie where the plain version's are; ``close`` elsewhere."""
    kw = nonfinite_tensors(dev, nonfinite.agg_case(N + f, N, M, f, D))
    got = sage_agg.sage_agg_bwd(kw["g"], kw["nbr_idx"], kw["src_valid"],
                                kw["cnt"], N)
    want = ref.sage_agg_bwd_ref(kw["g"], kw["nbr_idx"], kw["src_valid"],
                                kw["cnt"], N)
    torch.cuda.synchronize()
    assert nan_close(got, want)
    assert bool(torch.isnan(want[0]).all())         # the pads' row
    # a non-finite g row only at rows with no kept slot (rows 0 and 1,
    # whose g F's units never read), or only at a row with one (row 3)
    for rows in ((0, 1), (3,)):
        g = torch.randn(M, D, device=dev)
        g[list(rows), :4] = kw["g"][0, 0]
        got = sage_agg.sage_agg_bwd(g, kw["nbr_idx"], kw["src_valid"],
                                    kw["cnt"], N)
        want = ref.sage_agg_bwd_ref(g, kw["nbr_idx"], kw["src_valid"],
                                    kw["cnt"], N)
        torch.cuda.synchronize()
        assert nan_close(got, want) and not bool(torch.isfinite(want).all())
    g = torch.randn(M, D, device=dev)                # finite: the flag stays
    got = sage_agg.sage_agg_bwd(g, kw["nbr_idx"], kw["src_valid"], kw["cnt"],
                                N)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("N,M,f,H,dh", [(80, 20, 4, 2, 8), (300, 40, 7, 2, 6),
                                        (300, 40, 40, 4, 16),
                                        (20000, 4000, 5, 4, 256),
                                        (3000, 64, 15, 1, 172)])
@pytest.mark.parametrize("kind", nonfinite.GAT_KINDS)
def test_gat_bwd_keeps_nonfinite(dev, N, M, f, H, dh, kind):
    """Kernel H on non-finite g rows, NaN and inf z rows (masked, padded
    and kept sources) and a NaN e_u row (a NaN softmax), over pads, masked
    sources, indices past N and a row with no kept slot: dz, de_u and de_v
    carry NaN and inf exactly where the plain version's (the reference's
    autodiff's) are, also through autograd."""
    kw = nonfinite_tensors(dev, nonfinite.gat_case(N + f + H, N, M, f, H,
                                                   dh, kind))
    g = kw.pop("g")
    got = gat_edge.gat_edge_bwd(g, **kw)
    want = ref.gat_edge_bwd_ref(g, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.shape == b.shape and nan_close(a, b)
    z = kw["z"].clone().requires_grad_(True)
    eu = kw["e_u"].clone().requires_grad_(True)
    out = gat_edge.gat_edge_aggregate(z, eu, kw["e_v"], kw["nbr_idx"],
                                      kw["src_valid"])
    out.backward(g)
    torch.cuda.synchronize()
    assert nan_close(z.grad, want[0]) and nan_close(eu.grad, want[1])


@pytest.mark.parametrize("N,C,K", [(300, 96, 130), (1000, 256, 172),
                                   (17001, 256, 256), (176000, 128, 256)])
@pytest.mark.parametrize("relu,dropout", [(True, 0.0), (True, 0.5),
                                          (False, 0.0)])
def test_update_fwd_keeps_inf(dev, N, C, K, relu, dropout):
    """Kernel C on +-inf inputs, near-FLT_MAX ones (whose TF32 part is
    inf) under finite, overflowing and zero weights, and an inf times a
    weight of 0: +-inf and NaN exactly where the float32 product of the
    plain version has them, ``close`` elsewhere."""
    kw = nonfinite_tensors(dev, nonfinite.update_case(N + K, N, C, K))
    out = update_fused.update_fused_fwd(relu=relu, dropout=dropout, seed=9,
                                        **kw)
    want = ref.fused_update_ref(relu=relu, dropout=dropout, seed=9, **kw)
    torch.cuda.synchronize()
    assert nan_close(out, want)
    if not relu:
        assert bool(torch.isinf(want[:5]).any()) and bool(
            torch.isfinite(want[3]).all())


@pytest.mark.parametrize("N,M,f,D,K", [(300, 37, 7, 24, 47),
                                       (2000, 512, 10, 256, 172),
                                       (67584, 11264, 5, 128, 256),
                                       (10000, 2048, 12, 128, 130)])
def test_serve_kernel_keeps_inf(dev, N, M, f, D, K):
    """Kernel A on +-inf and near-FLT_MAX rows (kept, masked, the pads'
    row 0) under overflowing and zero weights: the plain version's +-inf
    and NaN, ``close`` elsewhere, with and without ReLU."""
    kw = nonfinite_tensors(dev, nonfinite.serve_case(N + K, N, M, f, D, K))
    for relu in (True, False):
        got = serve_fused.serve_fused_layer(relu=relu, **kw)
        want = ref.serve_layer_ref(relu=relu, **kw)
        torch.cuda.synchronize()
        assert nan_close(got, want)
        assert bool((~torch.isfinite(want)).any())


# ---------------------------------------------------------------------------
# the resilience plane's step on the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model", ["graphsage", "gat"])
def test_armed_clean_step_is_unarmed(dev, model):
    """The NaN/Inf guard armed, every fault code 0: the unarmed steps'
    bits in every metric and state tensor, and the same kernel launches
    (the guard adds no kernel)."""
    from repro_torch import resilience

    def counts():
        return [w.launches for w in (
            update_fused.update_fused_fwd, update_fused.update_fused_bwd,
            sage_agg.sage_agg_fwd, sage_agg.sage_agg_bwd,
            gat_edge.gat_edge_fwd, gat_edge.gat_edge_bwd,
            hec_search.hec_lookup)]
    c0 = counts()
    la, sa_ = repeat_run(dev, model)
    c1 = counts()
    lb, sb = repeat_run(dev, model, plane=resilience.ResiliencePlane(
        resilience.ResilienceConfig(nan_guard=True)))
    c2 = counts()
    assert [m.pop("skipped") for m in lb] == [0.0] * len(lb)
    assert la == lb and bit_equal(sa_, sb)
    assert [b - a for a, b in zip(c0, c1)] == [b - a for a, b in zip(c1, c2)]


@pytest.mark.parametrize("model", ["graphsage", "gat"])
def test_skipped_step_keeps_params_moments_and_count(dev, model):
    """A step whose rank 1 has the nan_step code on the card: skipped,
    the parameters, both moments and Adam's count as they were, the
    poisoned rank's pushed rows all filtered; the next clean step goes
    on as from the state before."""
    from repro_torch import resilience
    from repro_torch.configs.gnn import HECConfig, small_gnn_config
    from repro_torch.graph import partition_graph, synthetic_graph
    from repro_torch.pipeline.prefetcher import SamplingPlan
    from repro_torch.train.gnn_trainer import (DistTrainer, build_dist_data,
                                               minibatch_to_device)
    g = synthetic_graph(num_vertices=3000, avg_degree=10, num_classes=6,
                        feat_dim=24, seed=0)
    ps = partition_graph(g, 4, seed=0)
    cfg = small_gnn_config(model, batch_size=64, feat_dim=24, num_classes=6,
                           hidden_size=32, num_hidden_layers=2,
                           fanouts=(4, 5, 6),
                           hec=HECConfig(cache_size=4096, ways=4,
                                         push_limit=128))
    plan = SamplingPlan(ps, cfg, 0)
    hosts = list(plan.batches(plan.epoch_schedule(0), 0))[:2]
    tr = DistTrainer(cfg, 4, device=dev, resilience=resilience.ResiliencePlane(
        resilience.ResilienceConfig(nan_guard=True)))
    data = build_dist_data(ps, cfg, dev)
    st = tr.init_state(seed=3)
    m0 = tr.train_step(st, data, minibatch_to_device(hosts[0], dev), 0)
    assert m0["skipped"] == 0.0 and st["opt"].step == 1

    def tensors():
        return [t.detach().cpu().clone() for t in
                st["model"].parameter_list() + st["opt"].mu + st["opt"].nu]
    before = tensors()
    codes = np.array([0, resilience.CODE_NAN_STEP, 0, 0], np.int32)
    m1 = tr.train_step(st, data, minibatch_to_device(hosts[1], dev), 1,
                       codes)
    torch.cuda.synchronize()
    assert m1["skipped"] == 1.0 and m1["loss"] == m1["grad_norm"] == 0.0
    assert st["opt"].step == 1 and st["step"] == 2
    assert bit_equal(tensors(), before)
    assert int(tr.rank_stats["rank_push_rows"][1]) == 0
    m2 = tr.train_step(st, data, minibatch_to_device(hosts[1], dev), 2)
    assert m2["skipped"] == 0.0 and st["opt"].step == 2
    assert np.isfinite(m2["loss"])


# ---------------------------------------------------------------------------
# LM serving (no kernel of its own: plain torch on the card against the
# CPU; small versions of chip_smoke.py phase 14)
# ---------------------------------------------------------------------------
LM_ARCHS = ("command-r-plus-104b", "h2o-danube-3-4b", "minitron-4b",
            "minitron-8b", "mixtral-8x7b", "phi3.5-moe-42b-a6.6b",
            "qwen2-vl-7b", "recurrentgemma-9b", "seamless-m4t-medium",
            "xlstm-1.3b")


def lm_setup(arch, dev, dtype="float32", seed=0):
    import dataclasses as dc
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import model as M
    cfg = dc.replace(get_arch(arch).reduced(), dtype=dtype)
    return cfg, M.init_params(seed, cfg, "cpu")


def lm_batch(cfg, B, T, device, seed=1):
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, T)),
                                     device=device)}
    if cfg.num_patch_tokens:
        out["patch_embeds"] = torch.as_tensor(rng.normal(size=(
            B, cfg.num_patch_tokens, cfg.d_model)).astype(np.float32),
            device=device)
    if cfg.is_encoder_decoder:
        out["frame_embeds"] = torch.as_tensor(rng.normal(size=(
            B, cfg.num_frame_tokens, cfg.d_model)).astype(np.float32),
            device=device)
    return out


def lm_run(cfg, params, batch, steps, feed=None):
    """Prefill, then ``steps`` greedy decode steps (or the ids ``feed``)
    from the prefill caches: (logits, ids, caches)."""
    from repro_torch.models.transformer import model as M
    from repro_torch.train import lm_trainer as L
    logits, caches = L.make_prefill_step(cfg)(params, batch)
    pos = batch["tokens"].shape[1] + (cfg.num_patch_tokens
                                      if "patch_embeds" in batch else 0)
    tok = torch.argmax(logits[:, -1], -1)[:, None]
    outs, ids = [logits], [tok]
    serve = L.make_serve_step(cfg)
    for i in range(steps):
        if feed is not None:
            tok = feed[i]
        tok, lg, caches = serve(params, caches, tok.long(), pos + i)
        outs.append(lg)
        ids.append(tok)
    return outs, ids, M.tree_leaves(caches)


def lm_err(got, want):
    g, w = got.double().cpu(), want.double().cpu()
    return float(((g - w).abs() / w.abs().clamp_min(1.0)).max())


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_card_matches_cpu(dev, arch):
    """Each family (reduced, float32): prefill 2 x 16 and 4 decode steps
    on the card against the CPU from the same weights: logits and cache
    states within 1e-4 * max(1, |x|) (xLSTM: four times the card's own
    spread, its logits' and cache states' under 1e-7 relative embedding
    noise, as phase 14 (a)), cache positions and greedy ids equal."""
    from repro_torch.models.transformer import model as M
    from repro_torch.train import lm_trainer as L
    cfg, params = lm_setup(arch, dev)
    card_params = M.tree_map(lambda a: a.to(dev), params)
    batch = lm_batch(cfg, 2, 16, dev)
    got, ids, cache = lm_run(cfg, card_params, batch, 4)
    want, want_ids, want_cache = lm_run(
        cfg, params, {k: v.cpu() for k, v in batch.items()}, 4,
        feed=[t.cpu() for t in ids])
    tol = 1e-4
    if arch == "xlstm-1.3b":
        prefill = L.make_prefill_step(cfg)
        base, base_cache = prefill(card_params, batch)
        noisy = dict(card_params, embed=card_params["embed"] * (
            1 + 1e-7 * torch.randn_like(card_params["embed"])))
        lg, nc = prefill(noisy, batch)
        spread = max([lm_err(lg, base)] + [
            lm_err(a, b) for a, b in zip(M.tree_leaves(nc),
                                         M.tree_leaves(base_cache))
            if a.dtype.is_floating_point])
        tol = max(tol, 4 * spread)
    assert max(lm_err(a, b) for a, b in zip(got, want)) <= tol
    assert all(torch.equal(a.cpu(), b.to(a.dtype))
               for a, b in zip(ids, want_ids))
    for a, b in zip(cache, want_cache):
        if a.dtype.is_floating_point:
            assert lm_err(a, b) <= tol
        else:
            assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("arch", ["minitron-4b", "mixtral-8x7b",
                                  "recurrentgemma-9b"])
def test_scheduler_rows_match_per_slot_loop(dev, arch):
    """The scheduler's one decode with a position per slot against a loop
    that decodes each request alone (batch 1, scalar positions) on the
    card: the same ids; mixtral routes each slot as a group of its own
    (5 slots > E/K = 2)."""
    from repro_torch.models.transformer import model as M
    from repro_torch.serve.scheduler import Request, serve_requests
    cfg, params = lm_setup(arch, dev)
    params = M.tree_map(lambda a: a.to(dev), params)
    reqs = [Request(rid=i, prompt=[(5 * i + j) % 97 + 1
                                   for j in range(2 + i % 4)], max_tokens=5)
            for i in range(9)]
    serve_requests(cfg, params, reqs, num_slots=5, cache_len=24, device=dev)
    for r in reqs:
        cache = M.init_cache(cfg, 1, 24, device=dev)
        seq, gen = list(r.prompt), []
        for pos in range(len(r.prompt) + r.max_tokens - 1):
            tok = torch.tensor([[seq[pos]]], device=dev)
            logits, cache = M.decode_step(params, cfg, cache, tok, pos)
            if pos >= len(r.prompt) - 1:
                gen.append(int(torch.argmax(logits[0, -1])))
                seq.append(gen[-1])
        assert r.done and r.generated == gen, r.rid


def test_moe_group_of_one_matches_vmap(dev):
    """``apply_moe(per_row=True)`` routes each row alone, as the
    reference's vmap of a single token does: equal to one call per row on
    the card, within 1e-4; one group of all 24 rows (C = 16 < 24 picks
    of expert 1) is not."""
    from repro_torch.models.transformer import moe
    cfg, params = lm_setup("mixtral-8x7b", dev)
    mp = {k: v[0].to(dev) for k, v in params["seg0"]["b0"]["moe"].items()}
    mp["router"] = torch.zeros_like(mp["router"])
    mp["router"][:, 1] = 1.0
    x = torch.as_tensor(np.abs(np.random.default_rng(2).normal(
        size=(24, 1, cfg.d_model))).astype(np.float32), device=dev)
    got = moe.apply_moe(mp, x, cfg, per_row=True)
    want = torch.cat([moe.apply_moe(mp, x[i:i + 1], cfg) for i in range(24)])
    assert lm_err(got, want) <= 1e-4
    grouped = moe.apply_moe(mp, x.reshape(1, 24, -1), cfg).reshape(24, 1, -1)
    assert lm_err(grouped, want) > 1e-2


@pytest.mark.parametrize("arch,T", [("minitron-4b", 48),
                                    ("h2o-danube-3-4b", 96),
                                    ("command-r-plus-104b", 32)])
def test_lm_prefill_matches_replay_bf16(dev, arch, T):
    """bfloat16 on the card: the prefill's last logits against the prompt
    replayed through decode from an empty cache (danube at 96 tokens past
    its reduced 64-slot ring), within the reference test's atol = rtol =
    2e-2; command-r's one unit likewise, finite."""
    from repro_torch.models.transformer import model as M
    from repro_torch.train import lm_trainer as L
    cfg, params = lm_setup(arch, dev, dtype="bfloat16")
    params = M.tree_map(lambda a: a.to(dev, torch.bfloat16), params)
    batch = lm_batch(cfg, 2, T, dev)
    logits, _ = L.make_prefill_step(cfg)(params, batch)
    cache = M.init_cache(cfg, 2, T, device=dev)
    serve = L.make_serve_step(cfg)
    for t in range(T):
        _, lg, cache = serve(params, cache, batch["tokens"][:, t:t + 1], t)
    assert bool(torch.isfinite(logits).all())
    assert bool(((lg - logits).abs() <= 2e-2 + 2e-2 * logits.abs()).all())


def _lm_rms(got, want):
    sq = sum(float((g.double().cpu() - w.double().cpu()).pow(2).sum())
             for g, w in zip(got, want))
    return (sq / sum(w.numel() for w in want)) ** 0.5


@pytest.mark.parametrize("arch", ["minitron-4b", "mixtral-8x7b"])
def test_lm_bf16_card_matches_cpu(dev, arch, monkeypatch):
    """bfloat16 (reduced), as phase 14 (a) in bf16: the first block's
    attention on the CPU's bf16 rotated q, k and v of a 2 x 32 prompt, at
    least 99% of its bf16 outputs bit for bit on the card; the logits of
    the prefill and 2 decode steps (the CPU fed the card's ids) within
    0.65 of the CPU's bf16-vs-float32 rms distance from the CPU's (the CPU
    path that ``tests/test_torch_lm_bf16.py`` holds to the reference's
    own bf16 run).  The card with its scores rounded to bf16 falls past
    both."""
    import dataclasses as dc
    from repro_torch.models.transformer import blocks as TB
    from repro_torch.models.transformer import model as M
    from repro_torch.models.transformer.attention import dot_attention
    from repro_torch.models.transformer.rope import (rope_angles,
                                                     rope_cos_sin, rotate)
    from repro_torch.models.transformer.xlstm import rms_norm
    cfg, params = lm_setup(arch, dev, dtype="bfloat16")
    card_params = M.tree_map(lambda a: a.to(dev), params)
    batch = lm_batch(cfg, 2, 32, dev)
    host = {k: v.cpu() for k, v in batch.items()}
    x = M.embed_inputs(params, cfg, host["tokens"], None)[0]
    pos = torch.arange(32, dtype=torch.int32)[None].expand(2, 32)
    bp = M.tree_map(lambda a: a[0], params["seg0"]["b0"])
    q, k, v = TB._qkv(bp, rms_norm(x, bp["ln1"], cfg.norm_eps), cfg)
    cos, sin = rope_cos_sin(rope_angles(pos, cfg.head_dim, cfg.rope_theta,
                                        None), x.dtype)
    q, k = rotate(q, cos, sin), rotate(k, cos, sin)

    def attention(d):
        return dot_attention(q.to(d), k.to(d), v.to(d), pos.to(d), pos.to(d),
                             window=TB.block_window(cfg, cfg.pattern[0])).cpu()

    def card():
        got, ids, _ = lm_run(cfg, card_params, batch, 2)
        return got, ids, attention(dev)
    got, ids, attn = card()
    feed = [t.cpu() for t in ids]
    want = lm_run(cfg, params, host, 2, feed=feed)[0]
    f32 = lm_run(dc.replace(cfg, dtype="float32"), params, host, 2,
                 feed=feed)[0]
    want_attn = attention("cpu")
    dist = _lm_rms(want, f32)
    assert float((attn == want_attn).float().mean()) >= 0.99
    assert _lm_rms(got, want) <= 0.65 * dist
    einsum = torch.einsum
    monkeypatch.setattr(torch, "einsum", lambda eq, *ops: (
        einsum(eq, *ops).bfloat16().float() if eq == "btkgd,bskd->btkgs"
        else einsum(eq, *ops)))
    got_c, _, attn_c = card()
    monkeypatch.undo()
    assert float((attn_c == want_attn).float().mean()) < 0.99
    assert _lm_rms(got_c, want) > 0.65 * dist


def lm_train_step(cfg, params, batch, steps=2):
    """``steps`` train steps (Adam, lr 3e-4) from ``params``, in place:
    each step's loss and gradient norm, then the leaves and moments."""
    from repro_torch.models.transformer import model as M
    from repro_torch.train import lm_trainer as L
    from repro_torch.train import optimizer as O
    opt = O.adam_init(M.tree_leaves(params))
    step = L.make_train_step(cfg, O.AdamConfig(lr=3e-4))
    metrics = []
    for _ in range(steps):
        _, _, m = step(params, opt, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, M.tree_leaves(params) + opt.mu + opt.nu


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ["minitron-4b", "mixtral-8x7b"])
def test_lm_train_step_card_matches_cpu(dev, arch, remat):
    """The reduced train step (float32, two steps) on the card against the
    CPU from the same weights: loss and gradient norm within 1e-4 *
    max(1, |x|), every parameter and moment likewise (Adam's lr 3e-4
    bounds what a gradient near its eps moves a parameter by); with remat
    the card's own step without remat bit for bit."""
    import dataclasses as dc
    from repro_torch.models.transformer import model as M
    cfg, params = lm_setup(arch, dev)
    cfg = dc.replace(cfg, remat=remat)
    batch = lm_batch(cfg, 2, 16, dev)
    batch["labels"] = torch.roll(batch["tokens"], -1, 1)
    host = {k: v.cpu() for k, v in batch.items()}
    card = M.tree_map(lambda a: a.to(dev), params)
    got_m, got = lm_train_step(cfg, card, batch)
    want_m, want = lm_train_step(cfg, params, host)
    for (gl, gn), (wl, wn) in zip(got_m, want_m):
        assert abs(gl - wl) <= 1e-4 * max(1, abs(wl))
        assert abs(gn - wn) <= 1e-4 * max(1, abs(wn))
    assert max(lm_err(a, b) for a, b in zip(got, want)) <= 1e-4
    if remat:
        plain = M.tree_map(lambda a: a.to(dev), lm_setup(arch, dev)[1])
        plain_m, plain_leaves = lm_train_step(dc.replace(cfg, remat=False),
                                              plain, batch)
        assert plain_m == got_m
        assert all(torch.equal(a, b) for a, b in zip(got, plain_leaves))


def test_lm_train_entry_points_raise_without_card(monkeypatch):
    """Without a card, the train step's entry points refuse the default
    device rather than fall back to the CPU."""
    from repro_torch.launch import train
    from repro_torch.train.data import TokenStream
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["lm", "--arch", "minitron-4b", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TokenStream(vocab_size=10, batch=1, seq=4)
