"""Shared by the LM training parity tests (``tests/test_torch_lm_train_
*.py``): one train step of both packages from the reference's weights
(``_lm_parity.setup``) on ``tests/test_arch_smoke.py``'s batch, and a
second step of each from the reference's state after the first (the
port's moments from ``adam_state_from_reference``), each computed once
per process and arch (``functools.lru_cache``; the reference's step
jitted once per arch and remat setting).

The reference's side is its own train step split where the port's is
checked: ``jax.value_and_grad`` of the loss the reference's
``make_train_step`` differentiates (forward in train mode, the VLM's
text suffix, ``chunked_lm_loss``), then its ``adam_update``.

Tolerance, as the serving parity: 1e-4 * max(1, |reference|) on the
loss, every gradient leaf, the gradient norm and Adam's new parameters
and moments, both packages summing in float32 in other orders.  The
step's learning rate is the reference launcher's 3e-4: Adam's first
step moves a parameter by lr * g / (|g| + 1e-8), so a gradient entry
near 1e-8, whose float32 rounding differs between the two sums by a few
parts in ten, moves the parameter by up to lr times that (at 1e-3 a
reduced minitron-4b's step lands 8.2e-5 from the reference's, at 3e-4
~3e-5); :func:`adam_only` holds the port's Adam to the reference's on the
reference's own gradients, where no such amplification enters.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import TOL, rel_err, setup
from repro.models.transformer import model as RM
from repro.train import lm_trainer as RL
from repro.train import loss as RLoss
from repro.train import optimizer as RO
from repro_torch.models.transformer import model as M
from repro_torch.train import lm_trainer as L
from repro_torch.train import optimizer as O

LR = 3e-4
B, T = 2, 16            # tests/test_arch_smoke.py's batch


def ref_batch(rcfg):
    """``tests/test_arch_smoke.py:_batch(cfg, jax.random.key(2))``."""
    ks = jax.random.split(jax.random.key(2), 3)
    tokens = jax.random.randint(ks[0], (B, T), 0, rcfg.vocab_size)
    batch = {"tokens": tokens, "labels": jnp.roll(tokens, -1, 1)}
    if rcfg.num_patch_tokens:
        batch["patch_embeds"] = jax.random.normal(
            ks[1], (B, rcfg.num_patch_tokens, rcfg.d_model)).astype(
                jnp.float32)
    if rcfg.is_encoder_decoder:
        batch["frame_embeds"] = jax.random.normal(
            ks[2], (B, rcfg.num_frame_tokens, rcfg.d_model)).astype(
                jnp.float32)
    return batch


def port_batch(batch):
    return {k: torch.as_tensor(np.array(v)).long()
            if np.asarray(v).dtype.kind == "i" else torch.as_tensor(
                np.array(v)) for k, v in batch.items()}


def ref_loss_fn(rcfg):
    """The loss the reference's ``make_train_step`` differentiates."""
    def loss_fn(params, batch):
        hidden = RM.forward(params, rcfg, batch["tokens"], RL._extra(batch),
                            mode="train")
        if rcfg.num_patch_tokens:
            hidden = hidden[:, rcfg.num_patch_tokens:]
        return RLoss.chunked_lm_loss(params, rcfg, hidden, batch["labels"])
    return loss_fn


@functools.lru_cache(maxsize=None)
def _ref_step(arch, remat):
    import dataclasses
    rcfg = dataclasses.replace(setup(arch)[0], remat=remat)
    vg = jax.value_and_grad(ref_loss_fn(rcfg))
    opt_cfg = RO.AdamConfig(lr=LR)

    def step(params, opt, batch):
        loss, grads = vg(params, batch)
        new_p, new_o, diag = RO.adam_update(grads, opt, params, opt_cfg)
        return loss, grads, new_p, new_o, diag["grad_norm"]
    return jax.jit(step)


def port_params(arch):
    """A fresh copy of the reference's initial weights in the port."""
    return M.tree_map(lambda a: a.clone(), setup(arch)[3])


def run_port(cfg, params, opt, batch):
    """One port step; returns (loss, grads, grad_norm) with the gradients
    read through a hook on ``adam_update``; ``params`` and ``opt`` are
    updated in place."""
    seen = {}
    real = O.adam_update

    def spy(grads, state, leaves, opt_cfg):
        seen["grads"] = [g.detach().clone() for g in grads]
        return real(grads, state, leaves, opt_cfg)
    O.adam_update = spy
    try:
        _, _, m = L.make_train_step(cfg, O.AdamConfig(lr=LR))(
            params, opt, batch)
    finally:
        O.adam_update = real
    return float(m["loss"]), seen["grads"], float(m["grad_norm"])


def ref_two_steps(arch, params, remat=False):
    """The reference's two steps from ``params`` on the batch: each
    quantity of :func:`run` as a list of numpy leaves (``step2_`` for the
    second), and its params and Adam state after the first."""
    batch = ref_batch(setup(arch)[0])
    step = _ref_step(arch, remat)
    out, o = {}, RO.adam_init(params)
    for pre in ("", "step2_"):
        loss, grads, params, o, gn = step(params, o, batch)
        if not pre:
            state1 = (jax.tree_util.tree_map(np.asarray, params),
                      jax.tree_util.tree_map(np.asarray, o))
        for key, tree in (("loss", loss), ("grads", grads),
                          ("grad_norm", gn), ("params", params),
                          ("mu", o["mu"]), ("nu", o["nu"])):
            out[pre + key] = [np.asarray(a) for a in
                              jax.tree_util.tree_leaves(tree)]
    return out, state1


@functools.lru_cache(maxsize=None)
def run(arch, remat=False):
    """Both packages' two steps: (reference, port) dicts of lists of numpy
    leaves, ``loss``, ``grads``, ``grad_norm``, ``params``, ``mu`` and
    ``nu`` after the first step and the same under ``step2_``; the
    port's second step starts from the reference's state after the
    first."""
    import dataclasses
    rcfg, cfg, p, _ = setup(arch)
    cfg = dataclasses.replace(cfg, remat=remat)
    tb = port_batch(ref_batch(rcfg))
    ref, (params1, opt1) = ref_two_steps(arch, p, remat)
    tp = port_params(arch)
    starts = [(tp, O.adam_init(M.tree_leaves(tp))),
              (M.params_from_reference(params1, device="cpu"),
               M.adam_state_from_reference(opt1, device="cpu"))]
    port = {}
    for pre, (tp, topt) in zip(("", "step2_"), starts):
        loss, grads, gn = run_port(cfg, tp, topt, tb)
        port.update({pre + "loss": [np.float32(loss)],
                     pre + "grads": [g.numpy() for g in grads],
                     pre + "grad_norm": [np.float32(gn)],
                     pre + "params": [a.numpy() for a in M.tree_leaves(tp)],
                     pre + "mu": [a.numpy() for a in topt.mu],
                     pre + "nu": [a.numpy() for a in topt.nu]})
    return ref, port


def max_errors(arch, remat=False) -> dict:
    """The largest ``rel_err`` of each quantity, port against reference."""
    ref, port = run(arch, remat)
    out = {}
    for key, want in ref.items():
        assert len(port[key]) == len(want), (key, len(port[key]), len(want))
        out[key] = max(rel_err(g, w) for g, w in zip(port[key], want))
    return out


def check(arch, remat=False, spread=False):
    """Every quantity of :func:`run` within TOL, or with ``spread`` within
    4x the reference's own spread of it where that is larger."""
    errs = max_errors(arch, remat)
    tols = {k: max(TOL, 4 * train_spread(arch)[k]) if spread else TOL
            for k in errs}
    bad = {k: (v, tols[k]) for k, v in errs.items() if not v <= tols[k]}
    assert not bad, f"{arch}: (error, bound) {bad}"
    return errs


def adam_only(arch):
    """The port's ``adam_update`` on the reference's first-step gradients
    against the reference's new parameters and moments."""
    ref, _ = run(arch)
    tp = port_params(arch)
    leaves = M.tree_leaves(tp)
    opt = O.adam_init(leaves)
    O.adam_update([torch.from_numpy(np.array(g)) for g in ref["grads"]], opt, leaves,
                  O.AdamConfig(lr=LR))
    return max([rel_err(a.numpy(), w) for a, w in zip(leaves, ref["params"])]
               + [rel_err(a.numpy(), w) for a, w in zip(opt.mu, ref["mu"])]
               + [rel_err(a.numpy(), w) for a, w in zip(opt.nu, ref["nu"])])


@functools.lru_cache(maxsize=None)
def train_spread(arch, rel=1e-7, seed=0) -> dict:
    """How far each quantity of the reference's own two steps moves when
    its embedding is perturbed by ``rel`` relative noise (float32
    rounding's size): the floor below which no float32 implementation can
    be held to it (xLSTM's exponential gates amplify it)."""
    p = setup(arch)[2]
    base = ref_two_steps(arch, p)[0]
    e = np.asarray(p["embed"])
    rng = np.random.default_rng(seed)
    moved = ref_two_steps(arch, dict(p, embed=jnp.asarray(
        (e * (1 + rel * rng.standard_normal(e.shape))).astype(np.float32))))[0]
    return {k: max(rel_err(a, b) for a, b in zip(moved[k], base[k]))
            for k in base}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The training parity tests run torch on one thread: their models are
    tiny, and under the suite's parallel workers a backward of many small
    ops across a thread pool per worker spends its time in the pool's
    barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
