"""The port's LM serving path against the reference's for the MoE,
xLSTM and RG-LRU hybrid architectures at their ``reduced()`` widths (the
cases of ``test_torch_lm_dense.py``), the ring caches of mixtral's
sliding window and recurrentgemma's local attention past the reduced
window, and both MoE dispatches (einsum and gather) against the
reference's, with and without dropped tokens.

Tolerances in ``_lm_parity.py`` (1e-4 * max(1, |x|) on float32, ints and
ids exact); the MoE forward likewise.  xLSTM's whole model is held to
four times the reference's own spread instead (``reference_spread``: its
prefill logits move ~3e-4 when its embedding is perturbed by 1e-7
relative noise, float32 rounding's size; the port's caches sit within
2.5x that): at the reduced widths' random weights some mLSTM heads'
normalizers cancel (``|q . n|`` near ``exp(-m)``) and group norm
magnifies the rounding of every block ~10x.  Each block on the same
input is held to 1e-4 (``test_xlstm_blocks_match_reference``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import (RING_T, TOL, assert_close, assert_trees_close,
                        check_run, inputs, reference_spread, setup)
from repro.models.transformer import model as RM
from repro.models.transformer import xlstm as RX
from repro_torch.models.transformer import model as M
from repro_torch.models.transformer import xlstm as X

ARCHS = ("mixtral-8x7b", "phi3.5-moe-42b-a6.6b", "xlstm-1.3b",
         "recurrentgemma-9b")


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_path_matches_reference(arch):
    tol = TOL
    if arch == "xlstm-1.3b":
        tol = max(TOL, 4 * reference_spread(arch))
    check_run(arch, tol=tol)


def test_xlstm_blocks_match_reference():
    """Each of xLSTM's eight blocks (7 mLSTM, 1 sLSTM) on the reference's
    own input to it: the prefill's output and states (chunkwise mLSTM),
    then one decode step from those states (the sequential step)."""
    rcfg, cfg, p, tp = setup("xlstm-1.3b")
    tokens = inputs(cfg, 2, 8)["tokens"]
    x, _ = RM.embed_inputs(p, rcfg, jnp.asarray(tokens), None)
    step = np.random.default_rng(5).normal(size=(2, 1, cfg.d_model))
    for i, bt in enumerate(cfg.pattern):
        rp = {k: v[0] for k, v in p["seg0"][f"b{i}"].items()}
        tp_ = {k: v[0] for k, v in tp["seg0"][f"b{i}"].items()}
        rf, tf = ((RX.apply_mlstm_block, X.apply_mlstm_block) if bt == "mlstm"
                  else (RX.apply_slstm_block, X.apply_slstm_block))
        xt = torch.as_tensor(np.array(x))
        y, st = rf(rp, x, rcfg, None, "prefill")
        ty, tst = tf(tp_, xt, cfg, None, "prefill")
        assert_close(ty, np.asarray(y), f"block {i} prefill")
        assert_trees_close(tst, st, f"block {i} prefill state")
        xs = jnp.asarray(step, jnp.float32)
        y2, st2 = rf(rp, xs, rcfg, st, "decode")
        ty2, tst2 = tf(tp_, torch.as_tensor(step).float(), cfg,
                       M.cache_from_reference(
                           jax.tree_util.tree_map(np.asarray, st)), "decode")
        assert_close(ty2, np.asarray(y2), f"block {i} decode")
        assert_trees_close(tst2, st2, f"block {i} decode state")
        x = y


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "recurrentgemma-9b"])
def test_ring_cache_past_the_window(arch):
    check_run(arch, batch_size=1, length=RING_T, after=4, steps=0)


@pytest.mark.parametrize("impl", ["einsum", "gather"])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "phi3.5-moe-42b-a6.6b"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_dispatch_matches_reference(arch, impl, capacity_factor):
    """The train-mode forward (2 x 32 tokens, one group of 64) through
    either dispatch; at capacity factor 0.5 (C = 16 of 64 tokens' 128
    choices) tokens are dropped, and the port drops the same ones."""
    rcfg, cfg, p, tp = setup(arch)
    rcfg = dataclasses.replace(rcfg, moe_impl=impl,
                               capacity_factor=capacity_factor)
    cfg = dataclasses.replace(cfg, moe_impl=impl,
                              capacity_factor=capacity_factor)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 32))
    want = np.asarray(RM.forward(p, rcfg, jnp.asarray(tokens, jnp.int32)))
    got = M.forward(tp, cfg, torch.as_tensor(tokens))
    assert_close(got, want, f"{arch} {impl} forward")
    other = M.forward(tp, dataclasses.replace(
        cfg, moe_impl="gather" if impl == "einsum" else "einsum"),
        torch.as_tensor(tokens))
    assert_close(got, other.numpy(), f"{arch} einsum vs gather")
