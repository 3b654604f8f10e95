"""The port's LM train step against the reference's for the MoE, VLM and
encoder-decoder architectures at their ``reduced()`` widths (one step
from the reference's weights on ``tests/test_arch_smoke.py``'s batch,
then a second from the reference's state, as in
``test_torch_lm_train_dense.py``): the MoE's router and experts, the
VLM's loss on its text suffix only, the encoder's gradients; mixtral
with remat (the stable top-k picks the same experts when a unit is
recomputed: the step bit for bit); ``moe_aux_loss``; the LM part of
``train/data.py``: ``TokenStream`` bit for bit with the reference's
(``tests/test_data.py``'s contract) and ``Prefetcher``'s order.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import _lm_train_parity as P
from _lm_train_parity import one_torch_thread  # noqa: F401
from _lm_parity import TOL, rel_err, setup
from repro.models.transformer import moe as rmoe
from repro.train.data import Prefetcher as RPrefetcher
from repro.train.data import TokenStream as RTokenStream
from repro_torch.models.transformer import moe
from repro_torch.train.data import Prefetcher, TokenStream

MIXED = ("mixtral-8x7b", "phi3.5-moe-42b-a6.6b", "qwen2-vl-7b",
         "seamless-m4t-medium")


@pytest.mark.parametrize("arch", MIXED)
def test_train_step_matches_reference(arch):
    P.check(arch)


def test_moe_remat_repeats_bit_for_bit():
    _, on = P.run("mixtral-8x7b", remat=True)
    _, off = P.run("mixtral-8x7b", remat=False)
    for key, want in off.items():
        assert all(np.array_equal(a, b) for a, b in zip(on[key], want)), key


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "phi3.5-moe-42b-a6.6b"])
def test_moe_aux_loss_matches_reference(arch):
    rcfg, cfg, p, tp = setup(arch)
    x = np.random.default_rng(3).normal(size=(2, 16, cfg.d_model)).astype(
        np.float32)
    bp = jax.tree_util.tree_map(lambda a: a[0], p["seg0"]["b0"]["moe"])
    want = float(rmoe.moe_aux_loss(bp, jax.numpy.asarray(x), rcfg))
    got = moe.moe_aux_loss({k: v[0] for k, v in tp["seg0"]["b0"]["moe"].items()},
                           torch.as_tensor(x), cfg)
    assert rel_err(float(got), want) <= TOL
    # a router that sends every token to expert 0 first: f_0 = 1
    router = torch.zeros(cfg.d_model, cfg.num_experts)
    router[:, 0] = 1.0
    skew = moe.moe_aux_loss({"router": router}, torch.ones(1, 4, cfg.d_model),
                            dataclasses.replace(cfg, top_k=1))
    assert float(skew) == pytest.approx(cfg.num_experts, rel=1e-6)


@pytest.mark.parametrize("seed,step,signal", [(7, 3, 0.8), (0, 0, 0.8),
                                              (1, 5, 1.0), (123, 41, 0.3)])
def test_token_stream_bit_for_bit(seed, step, signal):
    ref = RTokenStream(vocab_size=100, batch=4, seq=16, seed=seed,
                       signal=signal).batch_at(step)
    port = TokenStream(vocab_size=100, batch=4, seq=16, seed=seed,
                       signal=signal, device="cpu")
    got = port.batch_at(step)
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        assert np.array_equal(got[k].numpy(), np.asarray(ref[k]))
    assert np.array_equal(port.table, RTokenStream(
        vocab_size=100, batch=4, seq=16, seed=seed).table)
    first = next(iter(port))
    assert np.array_equal(first["tokens"].numpy(),
                          port.batch_at(0)["tokens"].numpy())


def test_token_stream_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TokenStream(vocab_size=10, batch=1, seq=4)


def test_prefetcher_preserves_order():
    got = [int(b["x"][0]) for b in Prefetcher(
        iter([{"x": np.array([i])} for i in range(10)]), depth=3)]
    want = [int(b["x"][0]) for b in RPrefetcher(
        iter([{"x": np.array([i])} for i in range(10)]), depth=3)]
    assert got == want == list(range(10))
