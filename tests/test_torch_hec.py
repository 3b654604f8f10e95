"""The port's HEC state transitions against the reference's.

``hec_store``/``hec_tick`` run over the same random trace in ``repro``
(functional jnp) and ``repro_torch`` (in place); batches hold more than
``ways`` entries of one set, duplicate vids and -1 entries.  Tags and ages
must match bit for bit and values exactly; lookups, occupancy and the
single-rank ``EmbeddingCache`` surface must agree too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import hec as J
from repro_torch.cache import hec as T
from repro_torch.kernels.ref import set_index

CPU = torch.device("cpu")


def same_set_vids(nsets, target_set, count, start=0):
    """``count`` vids that hash to ``target_set``."""
    cand = np.arange(start, start + 200 * nsets * max(count, 1))
    sets = set_index(torch.as_tensor(cand), nsets).numpy()
    out = cand[sets == target_set][:count]
    assert len(out) == count
    return out


def make_batch(rng, nsets, ways, n, dim):
    vids = rng.integers(-1, 40 * nsets, n)
    k = ways + 3                                  # overflow one set
    vids[:k] = same_set_vids(nsets, int(rng.integers(nsets)), k,
                             start=int(rng.integers(1000)))
    vids[k:k + 3] = vids[k]                       # duplicates in one batch
    vids[-2:] = -1
    rng.shuffle(vids)
    return (vids.astype(np.int32),
            rng.normal(size=(n, dim)).astype(np.float32))


def assert_state_equal(ts, js):
    np.testing.assert_array_equal(ts.tags.numpy(), np.asarray(js.tags))
    np.testing.assert_array_equal(ts.age.numpy(), np.asarray(js.age))
    np.testing.assert_array_equal(ts.values.numpy().view(np.int32),
                                  np.asarray(js.values).view(np.int32))


@pytest.mark.parametrize("seed,ways", [(0, 2), (1, 4), (2, 8)])
def test_store_tick_trace_bitmatches_reference(seed, ways):
    rng = np.random.default_rng(seed)
    cs, dim, n = 16 * ways, 4, 40
    nsets = cs // ways
    ts = T.hec_init(cs, ways, dim, CPU)
    js = J.hec_init(cs, ways, dim)
    for step in range(12):
        vids, embs = make_batch(rng, nsets, ways, n, dim)
        T.hec_store(ts, torch.as_tensor(vids), torch.as_tensor(embs))
        js = J.hec_store(js, jnp.asarray(vids), jnp.asarray(embs))
        if step % 3 == 2:
            T.hec_tick(ts, life_span=4)
            js = J.hec_tick(js, life_span=4)
        assert_state_equal(ts, js)
        probe = np.concatenate([vids, rng.integers(-2, 40 * nsets, 16)]
                               ).astype(np.int32)
        hit, emb = T.hec_lookup(ts, torch.as_tensor(probe))
        jhit, jemb = J.hec_lookup(js, jnp.asarray(probe))
        np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
        np.testing.assert_array_equal(emb.numpy(), np.asarray(jemb))
        hs, ss, ws = T.hec_search(ts, torch.as_tensor(probe))
        jh, jset, jw = J.hec_search(js, jnp.asarray(probe))
        np.testing.assert_array_equal(ss.numpy(), np.asarray(jset))
        np.testing.assert_array_equal(ws.numpy(), np.asarray(jw))
        assert T.hec_occupancy(ts) == pytest.approx(
            float(J.hec_occupancy(js)))
    assert (ts.tags.numpy() >= 0).any()


def test_store_explicit_valid_mask_matches_reference():
    rng = np.random.default_rng(5)
    ts, js = T.hec_init(64, 4, 3, CPU), J.hec_init(64, 4, 3)
    vids, embs = make_batch(rng, 16, 4, 30, 3)
    valid = rng.random(30) < 0.6
    T.hec_store(ts, torch.as_tensor(vids), torch.as_tensor(embs),
                valid=torch.as_tensor(valid))
    js = J.hec_store(js, jnp.asarray(vids), jnp.asarray(embs),
                     valid=jnp.asarray(valid))
    assert_state_equal(ts, js)


def test_hec_init_refuses_ragged_cache():
    with pytest.raises(ValueError):
        T.hec_init(10, 4, 2, CPU)


def test_embedding_cache_surface_matches_reference():
    """warm + residency mirror + expandable masks + metrics + version bump
    of the single-rank cache, against the reference's."""
    from repro.serve.gnn.embedding_cache import ServingCache as JCache
    from repro.serve.gnn.embedding_cache import \
        ServeCacheConfig as JCfg
    from repro_torch.serve.gnn.embedding_cache import (ServeCacheConfig,
                                                       ServingCache)
    rng = np.random.default_rng(0)
    V, dims = 500, [6, 3]
    tc = ServingCache(dims, V, ServeCacheConfig(cache_size=128, ways=4),
                      device="cpu")
    jc = JCache(dims, V, JCfg(cache_size=128, ways=4))
    embs = [rng.normal(size=(V, d)).astype(np.float32) for d in dims]
    vids = rng.choice(V, 150, replace=False)
    assert tc.warm([torch.as_tensor(e) for e in embs], vids, chunk=64) == \
        jc.warm([jnp.asarray(e) for e in embs], vids, chunk=64)
    for ts, js in zip(tc.states, jc.states):
        assert_state_equal(ts, js)
    for a, b in zip(tc.resident, jc.resident):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tc.expandable_masks()[1:], jc.expandable_masks()[1:]):
        np.testing.assert_array_equal(a, b)
    hits, lookups = np.array([3, 1]), np.array([10, 4])
    tc.record(hits, lookups)
    jc.record(hits, lookups)
    assert tc.metrics() == pytest.approx(jc.metrics())
    assert tc.on_model_update() == jc.on_model_update() == 1
    assert tc.metrics() == pytest.approx(jc.metrics())
    assert not any(r.any() for r in tc.resident)
