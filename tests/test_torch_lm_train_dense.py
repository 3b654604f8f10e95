"""The port's LM train step (``train/lm_trainer.py:make_train_step``,
``train/loss.py``, ``train/optimizer.py``'s Adam over the LM tree) against
the reference's, for the four dense attention architectures at their
``reduced()`` widths: one step from the reference's weights on
``tests/test_arch_smoke.py``'s batch (the loss, every gradient leaf
against ``jax.grad`` of the loss the reference's step differentiates,
the gradient norm, Adam's new parameters and moments), and a second step
from the reference's state after the first (``adam_state_from_
reference``); minitron-4b with ``remat=True`` against the reference's
``jax.checkpoint`` and against the port without remat (bit for bit);
the chunked loss and ``softmax_xent`` (the contract of
``tests/test_models.py``), the chunked loss never keeping more than one
chunk's logits for the backward, Adam on a quadratic, and
``utils/tree.py``.

Tolerances in ``_lm_train_parity.py`` (1e-4 * max(1, |x|), float32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _lm_train_parity as P
from _lm_train_parity import one_torch_thread  # noqa: F401
from _lm_parity import TOL, rel_err, setup
from repro.train import loss as RLoss
from repro.models.transformer import model as RM
from repro.utils import tree as rtree
from repro_torch.models.transformer import model as M
from repro_torch.train import loss as loss_lib
from repro_torch.train import optimizer as O
from repro_torch.utils import tree as ptree

DENSE = ("command-r-plus-104b", "h2o-danube-3-4b", "minitron-4b",
         "minitron-8b")


@pytest.mark.parametrize("arch", DENSE)
def test_train_step_matches_reference(arch):
    P.check(arch)


@pytest.mark.parametrize("arch", DENSE)
def test_adam_on_reference_gradients(arch):
    assert P.adam_only(arch) <= 1e-6


def test_remat_matches_reference_checkpoint_and_plain():
    """Each unit under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint`` of the unit body): the reference's remat step
    within TOL, and the port's own step without remat bit for bit."""
    P.check("minitron-4b", remat=True)
    _, on = P.run("minitron-4b", remat=True)
    _, off = P.run("minitron-4b", remat=False)
    for key, want in off.items():
        assert all(np.array_equal(a, b) for a, b in zip(on[key], want)), key


def test_chunked_loss_matches_full_and_reference():
    """``tests/test_models.py``'s contract: 8 chunks equal the full
    logits' mean cross-entropy within 1e-5; the value is the
    reference's; its gradient is the full loss's."""
    rcfg, cfg, p, tp = setup("minitron-4b")
    tokens = jax.random.randint(jax.random.key(1), (2, 32), 0,
                                rcfg.vocab_size)
    labels = jnp.roll(tokens, -1, 1)
    want = float(RLoss.chunked_lm_loss(p, rcfg, RM.forward(p, rcfg, tokens),
                                       labels, num_chunks=8))
    ttok = torch.as_tensor(np.asarray(tokens)).long()
    tlab = torch.roll(ttok, -1, 1)
    hidden = M.forward(tp, cfg, ttok).detach().requires_grad_(True)
    chunked = loss_lib.chunked_lm_loss(tp, cfg, hidden, tlab, num_chunks=8)
    (g_chunked,) = torch.autograd.grad(chunked, hidden)
    full = loss_lib.softmax_xent(M.logits_from_hidden(tp, cfg, hidden), tlab)
    (g_full,) = torch.autograd.grad(full, hidden)
    chunked, full = float(chunked.detach()), float(full.detach())
    assert abs(chunked - full) <= 1e-5 * max(1, abs(full))
    assert rel_err(chunked, want) <= TOL
    assert rel_err(g_chunked.numpy(), g_full.numpy()) <= 1e-6
    # the masked mean: zero weight drops a token
    mask = torch.ones_like(tlab, dtype=torch.float32)
    mask[:, ::2] = 0
    rmask = jnp.asarray(mask.numpy())
    got = float(loss_lib.chunked_lm_loss(tp, cfg, hidden, tlab, mask=mask))
    assert rel_err(got, float(RLoss.chunked_lm_loss(
        p, rcfg, RM.forward(p, rcfg, tokens), labels, mask=rmask))) <= TOL
    assert rel_err(float(loss_lib.softmax_xent(
        M.logits_from_hidden(tp, cfg, hidden), tlab, mask)), got) <= 1e-6


def test_chunked_loss_keeps_one_chunk_of_logits():
    """What autograd keeps for the backward of the chunked loss holds no
    chunk's logits (each chunk's are recomputed there), so the live
    buffer is one chunk's, not the [B, T, V] a plain loop would keep."""
    _, cfg, _, tp = setup("minitron-4b")
    B, T, chunks = 2, 32, 8
    hidden = torch.randn(B, T, cfg.d_model, requires_grad=True)
    labels = torch.randint(0, cfg.vocab_size, (B, T))
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = loss_lib.chunked_lm_loss(tp, cfg, hidden, labels,
                                        num_chunks=chunks)
    logits = [s for s in saved if len(s) == 3 and s[-1] == cfg.vocab_size]
    assert sum(np.prod(s) for s in logits) <= B * T * cfg.vocab_size // chunks
    loss.backward()
    assert hidden.grad is not None and bool(torch.isfinite(hidden.grad).all())


def test_adam_reduces_quadratic():
    w = torch.tensor([5.0, -3.0])
    state = O.adam_init([w])
    for _ in range(100):
        O.adam_update([2 * w], state, [w], O.AdamConfig(lr=0.1))
    assert float((w ** 2).sum()) < 1e-2


def test_tree_helpers_match_reference():
    _, _, p, tp = setup("minitron-4b")
    assert ptree.tree_count_params(tp) == rtree.tree_count_params(p)
    assert ptree.tree_size_bytes(tp) == rtree.tree_size_bytes(p)
    assert ptree.tree_finite(tp) and rtree.tree_finite(p)
    bad = M.tree_map(lambda a: a.clone(), tp)
    bad["final_ln"][3] = float("nan")
    assert not ptree.tree_finite(bad)
    half = M.tree_map(lambda a: a.to(torch.bfloat16), tp)
    assert ptree.tree_size_bytes(half) == ptree.tree_size_bytes(tp) // 2


def test_bf16_scheduler_ids_hold_at_any_batch():
    """``BatchScheduler`` in bfloat16 at ``reduced()``: each request's ids
    at the scheduler's batch (4 slots, 6 requests, 2 in a reused slot) are
    those it gets alone at batch 1, in the reference and in the port
    alike (on the CPU; the card's batch-1 products may take other
    kernels than its batch-4 ones)."""
    import dataclasses
    from repro.serve.scheduler import BatchScheduler as RBS
    from repro.serve.scheduler import Request as RReq
    from repro_torch.serve.scheduler import BatchScheduler, Request
    rcfg, cfg, p, _ = setup("minitron-4b")
    rcfg = dataclasses.replace(rcfg, dtype="bfloat16")
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    p16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), p)
    tp = M.params_from_reference(jax.tree_util.tree_map(np.asarray, p),
                                 device="cpu", dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size,
                                             rng.integers(4, 12))]
               for _ in range(6)]

    def serve(make, req, slots, which):
        s = make(slots)
        reqs = [req(i, prompts[i], 24) for i in which]
        for r in reqs:
            s.submit(r)
        s.run()
        return [r.generated for r in reqs]
    for make, req in (
            (lambda n: RBS(rcfg, p16, n, 64), RReq),
            (lambda n: BatchScheduler(cfg, tp, n, 64, device="cpu"), Request)):
        batched = serve(make, req, 4, range(6))
        alone = [serve(make, req, 1, [i])[0] for i in range(6)]
        assert all(len(g) == 24 for g in batched)
        assert batched == alone
