"""The transposed slot index of kernels F and H (``kernels/slot_index.py``)
against a numpy reference, on the CPU: offsets, slots, chunk bases and
the chunk bound exactly, with hub rows (more than 4,096 slots), ``-1``
pads, indices at and past ``N`` and invalid sources.  And the fixed-order
gather the card runs through it, modelled in numpy: for every source row
of at most ``CHUNK`` slots it is the plain gradient's ``index_add_`` bit
for bit, and a hub's chunks add up within float32 rounding of it.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.slot_index import CHUNK, slot_index


def np_index(nbr, valid, N):
    """The index by its definition: for each source row, the kept slots
    in ascending order."""
    flat = nbr.reshape(-1)
    rows = [[] for _ in range(N)]
    for s, i in enumerate(flat):
        if 0 <= i < N and (valid is None or valid[i]):
            rows[i].append(s)
    offsets = np.zeros(N + 1, np.int32)
    offsets[1:] = np.cumsum([len(r) for r in rows])
    lens = np.diff(offsets)
    chunks = np.where(lens > CHUNK, -(-lens // CHUNK), 0)
    lbase = np.zeros(N + 1, np.int32)
    lbase[1:] = np.cumsum(chunks)
    return offsets, np.array([s for r in rows for s in r], np.int32), lbase


def matrix(seed, N, M, f, hubs=()):
    rng = np.random.default_rng(seed)
    nbr = rng.integers(-1, N + 3, (M, f)).astype(np.int32)
    flat = nbr.reshape(-1)
    pos = rng.permutation(flat.size)
    k = 0
    for hub, n in hubs:
        flat[pos[k:k + n]] = hub
        k += n
    valid = rng.random(N) > 0.2
    for hub, _ in hubs:
        valid[hub] = True
    return nbr, valid


CASES = [(0, 50, 30, 4, ()), (1, 2000, 1500, 5, ((7, 4500), (8, CHUNK + 1),
                                                 (9, CHUNK))),
         (2, 300, 400, 9, ((0, 1000),)), (3, 10, 5, 3, ()), (4, 1, 6, 2, ())]


@pytest.mark.parametrize("seed,N,M,f,hubs", CASES)
@pytest.mark.parametrize("with_valid", [True, False])
def test_slot_index_matches_numpy(seed, N, M, f, hubs, with_valid):
    nbr, valid = matrix(seed, N, M, f, hubs)
    v = valid if with_valid else None
    ix = slot_index(torch.as_tensor(nbr),
                    None if v is None else torch.as_tensor(v), N)
    offsets, slots, lbase = np_index(nbr, v, N)
    assert np.array_equal(ix.offsets.numpy(), offsets)
    assert np.array_equal(ix.slots.numpy()[:offsets[-1]], slots)
    assert np.array_equal(ix.lbase.numpy(), lbase)
    assert ix.slots.dtype == ix.offsets.dtype == ix.lbase.dtype == \
        torch.int32
    assert ix.lbound >= lbase[-1] and ix.num_src == N
    # the excluded slots follow the kept ones, each once
    assert sorted(ix.slots.numpy().tolist()) == list(range(M * f))


def test_slot_index_of_empty_matrices():
    ix = slot_index(torch.zeros((0, 5), dtype=torch.int32), None, 7)
    assert ix.offsets.tolist() == [0] * 8 and ix.lbound == 0
    ix = slot_index(torch.full((3, 2), -1, dtype=torch.int32),
                    torch.ones(4, dtype=torch.bool), 4)
    assert ix.offsets.tolist() == [0] * 5 and ix.lbase.tolist() == [0] * 5


def gather_model(g, cnt, ix, f):
    """Kernel F's arithmetic in numpy float32: each source row's quotients
    in ascending slot order from 0.0, a long row chunk by chunk, the
    chunks' partial sums then in chunk order from 0.0."""
    N = ix.num_src
    off, slots = ix.offsets.numpy(), ix.slots.numpy()
    den = np.maximum(cnt, np.float32(1.0))
    out = np.zeros((N, g.shape[1]), np.float32)
    for i in range(N):
        a, b = off[i], off[i + 1]
        parts = []
        for c0 in range(a, b, CHUNK):
            acc = np.zeros(g.shape[1], np.float32)
            for s in slots[c0:min(b, c0 + CHUNK)]:
                acc = acc + g[s // f] / den[s // f]
            parts.append(acc)
        if len(parts) == 1:
            out[i] = parts[0]
        elif parts:
            acc = np.zeros(g.shape[1], np.float32)
            for p in parts:
                acc = acc + p
            out[i] = acc
    return out


def test_fixed_order_gather_is_the_plain_gradient():
    """Rows of at most CHUNK slots: bit for bit the plain version's
    ``index_add_``; the hub rows: within float32 rounding."""
    N, M, f, D = 400, 900, 5, 6
    nbr, valid = matrix(5, N, M, f, ((3, 1000), (4, CHUNK + 3)))
    rng = np.random.default_rng(6)
    g = rng.normal(size=(M, D)).astype(np.float32)
    cnt = rng.integers(0, f + 1, M).astype(np.float32)
    ix = slot_index(torch.as_tensor(nbr), torch.as_tensor(valid), N)
    got = gather_model(g, cnt, ix, f)
    plain = ref.sage_agg_bwd_ref(torch.as_tensor(g), torch.as_tensor(nbr),
                                 torch.as_tensor(valid), torch.as_tensor(cnt),
                                 N).numpy()
    lens = np.diff(ix.offsets.numpy())
    short = lens <= CHUNK
    assert (~short).sum() == 2
    assert np.array_equal(got[short], plain[short])
    np.testing.assert_allclose(got[~short], plain[~short], rtol=1e-5,
                               atol=1e-4)
