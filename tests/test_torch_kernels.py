"""The port's kernels against the reference's, on the same numpy inputs.

On the CPU each wrapper runs its plain PyTorch version; those are held
against the reference's Pallas kernels in interpret mode and its jnp
oracles.  Float tolerance atol=rtol=1e-5 (torch and XLA sum float32 in
different orders); HEC hit/set/way and the loaded rows are held bit for
bit.  The CUDA kernels themselves are held against the plain versions on
the card by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import hec as j_hec
from repro.kernels import ref as j_ref
from repro.kernels.hec_search import hec_search_kernel
from repro.kernels.serve_fused import fused_serve_layer
from repro_torch.kernels import hec_search, ref, serve_fused

TOL = dict(atol=1e-5, rtol=1e-5)


def serve_inputs(seed, N, M, f, D, K, masked_rows=(), self_idx=False):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(N, D)).astype(np.float32)
    nbr = rng.integers(-1, N, (M, f)).astype(np.int32)
    for r in masked_rows:
        nbr[r] = -1
    valid = rng.random(N) > 0.2
    p = {"wn": (rng.normal(size=(D, K)) * 0.1).astype(np.float32),
         "ws": (rng.normal(size=(D, K)) * 0.1).astype(np.float32),
         "b": (rng.normal(size=K) * 0.1).astype(np.float32)}
    sidx = rng.integers(-3, N + 3, M).astype(np.int32) if self_idx else None
    return h, nbr, valid, p, sidx


def torch_serve(h, nbr, valid, p, sidx, relu, device="cpu"):
    t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    return serve_fused.serve_fused_layer(
        t(h), t(nbr), t(valid), t(p["wn"]), t(p["ws"]), t(p["b"]), relu=relu,
        self_idx=None if sidx is None else t(sidx))


SHAPES = [(64, 16, 5, 32, 32), (300, 37, 7, 24, 47), (257, 64, 3, 16, 130),
          (40, 40, 9, 8, 5)]


@pytest.mark.parametrize("N,M,f,D,K", SHAPES)
@pytest.mark.parametrize("relu", [True, False])
def test_serve_layer_matches_pallas_and_oracle(N, M, f, D, K, relu):
    h, nbr, valid, p, _ = serve_inputs(N + K, N, M, f, D, K,
                                       masked_rows=(0, M - 1))
    out = torch_serve(h, nbr, valid, p, None, relu).numpy()
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    pallas = np.asarray(fused_serve_layer(
        jnp.asarray(h), jnp.asarray(nbr), jnp.asarray(valid), jp["wn"],
        jp["ws"], jp["b"], relu=relu, interpret=True))
    oracle = np.asarray(j_ref.serve_layer_ref(
        jp, jnp.asarray(h), jnp.asarray(nbr), jnp.asarray(valid), relu=relu))
    assert out.shape == (M, K)
    np.testing.assert_allclose(out, pallas, **TOL)
    np.testing.assert_allclose(out, oracle, **TOL)
    # an all-masked row aggregates to zero: only self@Ws + b remains
    self_only = h[0] @ p["ws"] + p["b"]
    np.testing.assert_allclose(out[0], np.maximum(self_only, 0) if relu
                               else self_only, **TOL)


@pytest.mark.parametrize("N,M,f,D,K", SHAPES)
def test_serve_layer_self_idx_matches_oracle(N, M, f, D, K):
    """Offline-chunk form: self rows h[clip(self_idx)], as offline.py:74."""
    h, nbr, valid, p, sidx = serve_inputs(N, N, M, f, D, K, self_idx=True)
    out = torch_serve(h, nbr, valid, p, sidx, relu=True).numpy()
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    hj = jnp.asarray(h)
    oracle = np.asarray(j_ref.serve_layer_ref(
        jp, hj, jnp.asarray(nbr), jnp.asarray(valid),
        hj[jnp.clip(jnp.asarray(sidx), 0, N - 1)], relu=True))
    np.testing.assert_allclose(out, oracle, **TOL)


def test_serve_wrapper_cpu_runs_plain_version_uncounted():
    h, nbr, valid, p, sidx = serve_inputs(0, 50, 20, 4, 8, 6, self_idx=True)
    before = serve_fused.serve_fused_layer.launches
    t = torch.as_tensor
    got = torch_serve(h, nbr, valid, p, sidx, relu=True)
    want = ref.serve_layer_ref(t(h), t(nbr), t(valid), t(p["wn"]),
                               t(p["ws"]), t(p["b"]), self_idx=t(sidx))
    assert torch.equal(got, want)
    assert serve_fused.serve_fused_layer.launches == before


def test_wrappers_refuse_other_devices():
    m = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        serve_fused.serve_fused_layer(
            torch.empty(4, 3, device=m), torch.empty(2, 2, dtype=torch.int32,
                                                     device=m),
            torch.empty(4, dtype=torch.bool, device=m),
            torch.empty(3, 5, device=m), torch.empty(3, 5, device=m),
            torch.empty(5, device=m))
    with pytest.raises(ValueError, match="unsupported device"):
        hec_search.hec_lookup(torch.empty(4, 2, dtype=torch.int32, device=m),
                              torch.empty(4, 2, 3, device=m),
                              torch.empty(5, dtype=torch.int32, device=m))


EDGE_VIDS = np.array([-1, -2, -5, -2 ** 31, 2 ** 31 - 1, 0, 1, 255, 256,
                      0x7FFF_FFFF, 123_456_789], np.int32)


@pytest.mark.parametrize("nsets", [1, 7, 64, 8192])
def test_set_index_matches_reference(nsets):
    rng = np.random.default_rng(nsets)
    vids = np.concatenate([EDGE_VIDS, rng.integers(-2 ** 31, 2 ** 31, 500,
                                                   dtype=np.int64)
                           .astype(np.int32)])
    got = ref.set_index(torch.as_tensor(vids), nsets).numpy()
    want = np.asarray(j_hec.set_index(jnp.asarray(vids), nsets))
    np.testing.assert_array_equal(got, want.astype(np.int64))


def jax_state_from_trace(seed, cache_size, ways, dim, batches=6):
    """A partly filled reference HEC state: random stores, some same-set
    overflow, duplicate vids and -1 entries."""
    rng = np.random.default_rng(seed)
    st = j_hec.hec_init(cache_size, ways, dim)
    n = 32
    for _ in range(batches):
        vids = rng.integers(-1, 3 * cache_size, n).astype(np.int32)
        vids[: n // 4] = vids[0]                   # duplicates in one batch
        embs = rng.normal(size=(n, dim)).astype(np.float32)
        st = j_hec.hec_store(st, jnp.asarray(vids), jnp.asarray(embs))
    return st


@pytest.mark.parametrize("cache_size,ways,dim", [(64, 4, 8), (256, 8, 5),
                                                 (96, 32, 3)])
def test_hec_lookup_plain_matches_pallas_probe(cache_size, ways, dim):
    st = jax_state_from_trace(cache_size + ways, cache_size, ways, dim)
    tags, values = np.array(st.tags), np.array(st.values)
    rng = np.random.default_rng(1)
    stored = tags[tags >= 0]
    probe = np.concatenate([
        EDGE_VIDS, stored, rng.integers(-3, 3 * cache_size, 64)]
    ).astype(np.int32)
    hit_j, set_j, way_j = hec_search_kernel(st.tags, jnp.asarray(probe),
                                            interpret=True)
    emb_j = np.where(np.asarray(hit_j)[:, None],
                     np.asarray(j_hec.hec_load(st, set_j, way_j)), 0.0)
    hit, s, w, emb = hec_search.hec_lookup(
        torch.as_tensor(tags), torch.as_tensor(values),
        torch.as_tensor(probe))
    assert hit.dtype == torch.bool and s.dtype == w.dtype == torch.int32
    np.testing.assert_array_equal(hit.numpy(), np.asarray(hit_j))
    np.testing.assert_array_equal(s.numpy(), np.asarray(set_j))
    np.testing.assert_array_equal(w.numpy(), np.asarray(way_j))
    np.testing.assert_array_equal(emb.numpy().view(np.int32),
                                  emb_j.astype(np.float32).view(np.int32))
    assert hit.numpy()[: len(EDGE_VIDS)][EDGE_VIDS < 0].sum() == 0
    assert hit.numpy().any() and not hit.numpy().all()
