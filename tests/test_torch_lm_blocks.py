"""The port's LM building blocks against the reference's, one function at
a time: the config registry and shapes (field for field), RoPE and
M-RoPE, ``dot_attention`` (chunks, causal, window, softcap, empty and
fully masked rows), ``KVCache`` (update at one position and at one per
row, ``from_prefill`` past and short of its length, on a ring and not),
the mLSTM's sequential, chunkwise and ragged-tail forms, RG-LRU's scan and
step, the causal conv1d, MoE routing on ties, the initial weights (bit
for bit; the reference's per-unit ``vmap`` equal to a per-key split) and
``threefry.randint``.

Tolerance: float32 within 1e-4 * max(1, |x|) (the two packages sum in
other orders; RG-LRU's scan and the chunkwise mLSTM reorder their sums
differently from the reference's associative scan and chunk products);
integers and the drawn weights exactly; RG-LRU's closed-form ``lam``
(float64 here, XLA's float32 ``expm1`` there) within 1e-5 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import assert_close, assert_trees_close
from repro.configs import get_arch as ref_arch, list_archs as ref_list
from repro.configs import shapes as ref_shapes
from repro.models.transformer import attention as RA
from repro.models.transformer import model as RM
from repro.models.transformer import moe as RMoE
from repro.models.transformer import rglru as RR
from repro.models.transformer import rope as RRope
from repro.models.transformer import xlstm as RX
from repro_torch.configs import (SHAPES, get_arch, get_shape, list_archs,
                                 shape_applicable)
from repro_torch.models.transformer import attention as A
from repro_torch.models.transformer import model as M
from repro_torch.models.transformer import moe
from repro_torch.models.transformer import rglru as R
from repro_torch.models.transformer import rope
from repro_torch.models.transformer import xlstm as X
from repro_torch.pipeline import threefry

RNG = np.random.default_rng(0)


def arr(*shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


def t(a):
    return torch.as_tensor(np.array(a))


def test_registry_matches_reference():
    assert list_archs() == ref_list() and len(list_archs()) == 10
    for name in list_archs():
        got, want = get_arch(name), ref_arch(name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        assert dataclasses.asdict(got.reduced()) == \
            dataclasses.asdict(want.reduced()), name
        assert got.total_params() == want.total_params()
        assert got.active_params() == want.active_params()
        assert got.supports_long_context == want.supports_long_context
    with pytest.raises(KeyError):
        get_arch("no-such-arch")


def test_shapes_and_applicability_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_shapes.SHAPES.items()}
    for name in list_archs():
        for s in SHAPES:
            assert shape_applicable(get_arch(name), get_shape(s)) == \
                ref_shapes.shape_applicable(ref_arch(name),
                                            ref_shapes.get_shape(s))
    assert not shape_applicable(get_arch("minitron-4b"),
                                get_shape("long_500k"))[0]
    assert shape_applicable(get_arch("xlstm-1.3b"), get_shape("long_500k"))[0]
    with pytest.raises(KeyError):
        get_shape("nope")


@pytest.mark.parametrize("mrope", [None, (8, 4, 4)])
def test_rope_matches_reference(mrope):
    B, T, H, dh = 2, 7, 3, 32
    pos = RNG.integers(0, 5000, (B, 3, T) if mrope else (B, T)).astype(np.int32)
    x = arr(B, T, H, dh)
    want = RRope.apply_rope(jnp.asarray(x), RRope.rope_angles(
        jnp.asarray(pos), dh, 1e6, mrope))
    got = rope.apply_rope(t(x), rope.rope_angles(t(pos), dh, 1e6, mrope))
    assert_close(got, np.asarray(want))


@pytest.mark.parametrize("causal,window,softcap,q_chunk", [
    (True, None, None, 512), (False, None, None, 512), (True, 5, None, 512),
    (True, None, 30.0, 4), (True, 6, 50.0, 3)])
def test_dot_attention_matches_reference(causal, window, softcap, q_chunk):
    B, T, S, H, KV, dh = 2, 9, 12, 4, 2, 16
    q, k, v = arr(B, T, H, dh), arr(B, S, KV, dh), arr(B, S, KV, dh)
    q_pos = np.tile(np.arange(3, 3 + T, dtype=np.int32), (B, 1))
    q_pos[1, 0] = -1                         # a row with nothing to see
    kv_pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    kv_pos[0, -3:] = -1                      # empty slots
    kv_pos[1] = np.roll(kv_pos[1], 5)        # ring order
    kw = dict(causal=causal, window=window, softcap=softcap, q_chunk=q_chunk)
    want = RA.dot_attention(*map(jnp.asarray, (q, k, v, q_pos, kv_pos)), **kw)
    got = A.dot_attention(*map(t, (q, k, v, q_pos, kv_pos)), **kw)
    assert_close(got, np.asarray(want))
    if causal:
        assert float(got[1, 0].abs().max()) == 0.0


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("T,length", [(11, 4), (3, 8), (8, 8)])
def test_kv_cache_matches_reference(ring, T, length):
    B, KV, dh = 2, 2, 8
    k, v = arr(B, T, KV, dh), arr(B, T, KV, dh)
    want = RA.KVCache.from_prefill(jnp.asarray(k), jnp.asarray(v), length, ring)
    got = A.KVCache.from_prefill(t(k), t(v), length, ring)
    assert_trees_close(got, want)
    for step, pos in enumerate((T, T + 1, T + length + 2)):
        kn, vn = arr(B, 1, KV, dh), arr(B, 1, KV, dh)
        want = want.update(jnp.asarray(kn), jnp.asarray(vn), jnp.int32(pos))
        got = got.update(t(kn), t(vn), pos)
        assert_trees_close(got, want, f"step {step}")
    # one position per row: the reference's vmap of single-row updates
    rows = np.array([T + 3, 1], np.int64)
    kn, vn = arr(B, 1, KV, dh), arr(B, 1, KV, dh)
    def one_row(c, a, b, p):
        u = RA.KVCache(c.k[None], c.v[None], c.pos[None], ring).update(
            a[None], b[None], p)
        return RA.KVCache(u.k[0], u.v[0], u.pos[0], ring)
    vm = jax.vmap(one_row)
    want = vm(want, jnp.asarray(kn), jnp.asarray(vn),
              jnp.asarray(rows, jnp.int32))
    got = got.update(t(kn), t(vn), torch.as_tensor(rows))
    assert_trees_close(got, want, "per-row update")


@pytest.mark.parametrize("T,chunk", [(16, 16), (24, 8), (19, 8)])
def test_mlstm_forms_match_reference(T, chunk):
    B, H, dh = 2, 2, 8
    q, k, v = arr(B, T, H, dh), arr(B, T, H, dh), arr(B, T, H, dh)
    i_raw, f_raw = arr(B, T, H), arr(B, T, H, scale=2.0)
    ins = (q, k, v, i_raw, f_raw)
    h_s, st_s = RX.mlstm_sequential(*map(jnp.asarray, ins))
    h_c, st_c = RX.mlstm_chunkwise(*map(jnp.asarray, ins), chunk=chunk)
    g_s, gst_s = X.mlstm_sequential(*map(t, ins))
    g_c, gst_c = X.mlstm_chunkwise(*map(t, ins), chunk=chunk)
    assert_close(g_s, np.asarray(h_s))
    assert_close(g_c, np.asarray(h_c))
    assert_close(g_c, g_s.numpy())
    assert_trees_close(gst_s, st_s)
    assert_trees_close(gst_c, st_c)
    # a decode step continues the sequence from the carried state
    one = [arr(B, 1, H, dh) for _ in range(3)] + [arr(B, 1, H), arr(B, 1, H)]
    h1, st1 = RX.mlstm_step(*map(jnp.asarray, one), st_c)
    g1, gst1 = X.mlstm_step(*map(t, one), gst_c)
    assert_close(g1, np.asarray(h1))
    assert_trees_close(gst1, st1)


def test_rglru_and_conv_match_reference():
    B, T, W = 2, 13, 16
    x, r, i = arr(B, T, W), np.abs(arr(B, T, W)), np.abs(arr(B, T, W))
    r, i = 1 / (1 + np.exp(-r)), 1 / (1 + np.exp(-i))
    lam, h0 = arr(W), arr(B, W)
    for init in (None, h0):
        want, wl = RR.rglru_scan(*map(jnp.asarray, (x, r, i, lam)),
                                 None if init is None else jnp.asarray(init))
        got, gl = R.rglru_scan(*map(t, (x, r, i, lam)),
                               None if init is None else t(init))
        assert_close(got, np.asarray(want))
        assert_close(gl, np.asarray(wl))
    hs, wh = RR.rglru_step(*map(jnp.asarray, (x[:, :1], r[:, :1], i[:, :1],
                                              lam, h0)))
    gs, gh = R.rglru_step(*map(t, (x[:, :1], r[:, :1], i[:, :1], lam, h0)))
    assert_close(gs, np.asarray(hs))
    assert_close(gh, np.asarray(wh))
    w, buf = arr(4, W), arr(B, 3, W)
    for b in (None, buf):
        y, nb = RX.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                 None if b is None else jnp.asarray(b))
        gy, gb = X.causal_conv1d(t(x), t(w), None if b is None else t(b))
        assert_close(gy, np.asarray(y))
        assert np.array_equal(gb.numpy(), np.asarray(nb))


def test_moe_routing_ties_keep_the_lower_expert():
    """Equal router logits: ``jax.lax.top_k`` keeps the lower indices,
    and so does the port's stable sort; the GShard slot order follows."""
    x = arr(1, 6, 8)
    router = np.zeros((8, 4), np.float32)
    router[:, 3] = 1.0                       # expert 3 first, then 0 and 1 tie
    x = np.abs(x)
    g, idx = RMoE._route(jnp.asarray(router), jnp.asarray(x), 3)
    gg, gidx = moe._route(t(router), t(x), 3)
    assert np.array_equal(gidx.numpy(), np.asarray(idx))
    assert gidx[0, 0].tolist() == [3, 0, 1]
    assert_close(gg, np.asarray(g))
    pos = RMoE._positions_in_expert(idx, 4)
    assert np.array_equal(moe._positions_in_expert(gidx, 4).numpy(),
                          np.asarray(pos))


@pytest.mark.parametrize("arch", ["minitron-4b", "mixtral-8x7b"])
def test_init_params_bit_for_bit(arch):
    want = jax.tree_util.tree_leaves(RM.init_params(jax.random.key(3),
                                                    ref_arch(arch).reduced()))
    got = M.tree_leaves(M.init_params(3, get_arch(arch).reduced(), "cpu"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.array_equal(g.numpy().view(np.uint32),
                              np.asarray(w).view(np.uint32))


def test_unit_vmap_equals_per_key_split():
    """The reference draws a segment's units with ``vmap`` over split
    keys; with partitionable Threefry that is each key's own draw, which
    is what ``init_params`` computes (a segment of three units)."""
    cfg = dataclasses.replace(ref_arch("minitron-4b").reduced(),
                              num_layers=3, num_units=3)
    keys = jax.random.split(jax.random.key(5), 3)
    stacked = jax.vmap(lambda k: RM._init_unit(k, cfg, ("attn",), False))(keys)
    for u in range(3):
        one = RM._init_unit(keys[u], cfg, ("attn",), False)
        for a, b in zip(jax.tree_util.tree_leaves(one),
                        jax.tree_util.tree_leaves(stacked)):
            assert np.array_equal(np.asarray(a), np.asarray(b)[u])
    port = M._stack(("attn",), 3, threefry.split(threefry.key(5), 8)[2],
                    get_arch("minitron-4b").reduced(), False,
                    M._threefry_draw("cpu"), "cpu", torch.float32)
    ref = jax.vmap(lambda k: RM._init_unit(k, cfg, ("attn",), False))(
        jax.random.split(jax.random.split(jax.random.key(5), 8)[2], 3))
    for g, w in zip(M.tree_leaves(port), jax.tree_util.tree_leaves(ref)):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("width", [384, 6144])
def test_rglru_lambda_within_tolerance(width):
    """RG-LRU's Lambda at the reduced and the published rnn width."""
    cfg = dataclasses.replace(ref_arch("recurrentgemma-9b").reduced(),
                              rnn_width=width)
    want = np.asarray(RR.init_rglru_block(jax.random.key(0), cfg)[0]["lam"])
    got = M.block_spec(cfg, "rglru").leaves["lam"].make()
    assert np.max(np.abs(got / want - 1)) <= 1e-5


def test_randint_bit_for_bit():
    for seed, shape, hi in ((1, (2, 16), 512), (1, (2, 16), 256_000),
                            (2, (3, 5), 152_064), (4, (7,), 2 ** 31 - 1)):
        want = np.asarray(jax.random.randint(jax.random.key(seed), shape, 0, hi))
        got = threefry.randint(threefry.key(seed), shape, 0, hi).numpy()
        assert np.array_equal(got, want)
