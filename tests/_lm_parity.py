"""Shared by the LM parity tests (``tests/test_torch_lm_*.py``): reduced
configs of both packages, the reference's weights carried into the port
(``params_from_reference``), the same inputs (numpy, from a seed) and
both packages' prefill and decode runs, each computed once per process
and arch (``functools.lru_cache``; the reference's steps jitted).

Tolerance: the reduced configs are float32 and both packages sum in
float32, in other orders (XLA's dot and reductions, torch's), so float
logits and cache states are held to |port - reference| <= 1e-4 *
max(1, |reference|); integer leaves (cache positions) exactly, greedy
ids equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_arch as ref_arch
from repro.models.transformer import model as RM
from repro.train import lm_trainer as RL
from repro_torch.configs import get_arch
from repro_torch.models.transformer import model as M
from repro_torch.train import lm_trainer as L

TOL = 1e-4
B, T = 2, 8            # prompt batch of the prefill and decode cases
CACHE_LEN = 16         # decode-from-empty cache length
STEPS = 4              # decode steps after an empty cache
AFTER = 2              # decode steps continuing from the prefill caches
RING_T = 80            # a prompt past the reduced window (64)


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    if got.size == 0:
        return 0.0
    return float(np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want))))


def assert_close(got, want, what="", tol=TOL):
    err = rel_err(got, want)
    assert err <= tol, f"{what}: {err:.3e} > {tol:.3e}"


def assert_trees_close(port_tree, ref_tree, what="", tol=TOL):
    """Every leaf, in the reference's order: ints exactly, floats within
    TOL."""
    got = [t.detach().cpu().numpy() for t in M.tree_leaves(port_tree)]
    want = [np.asarray(a) for a in jax.tree_util.tree_leaves(ref_tree)]
    assert len(got) == len(want), (len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        if np.issubdtype(w.dtype, np.integer):
            assert np.array_equal(g, w), f"{what}: leaf {i} differs"
        else:
            assert_close(g, w, f"{what}: leaf {i}", tol)


@functools.lru_cache(maxsize=None)
def setup(arch):
    """(reference cfg, port cfg, reference params, port params)."""
    rcfg = ref_arch(arch).reduced()
    cfg = get_arch(arch).reduced()
    p = RM.init_params(jax.random.key(0), rcfg)
    tp = M.params_from_reference(jax.tree_util.tree_map(np.asarray, p),
                                 device="cpu")
    return rcfg, cfg, p, tp


def inputs(cfg, batch, length, seed=1):
    """numpy tokens and the modality stubs: patch embeddings with
    M-RoPE position streams that differ (t, h, w), frame embeddings."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, length))
           .astype(np.int32)}
    if cfg.num_patch_tokens:
        P = cfg.num_patch_tokens
        out["patch_embeds"] = rng.normal(
            size=(batch, P, cfg.d_model)).astype(np.float32)
        n = P + length
        grid = np.arange(P)
        t = np.concatenate([np.zeros(P), P + np.arange(length)])
        h = np.concatenate([grid // 4, P + np.arange(length)])
        w = np.concatenate([grid % 4, P + np.arange(length)])
        out["positions"] = np.broadcast_to(
            np.stack([t, h, w]).astype(np.int32), (batch, 3, n)).copy()
    if cfg.is_encoder_decoder:
        out["frame_embeds"] = rng.normal(
            size=(batch, cfg.num_frame_tokens, cfg.d_model)).astype(np.float32)
    return out


def _port_batch(batch):
    return {k: torch.as_tensor(v).long() if v.dtype.kind == "i"
            else torch.as_tensor(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _ref_steps(arch):
    rcfg = setup(arch)[0]
    return jax.jit(RL.make_prefill_step(rcfg)), jax.jit(RL.make_serve_step(rcfg))


def run(arch, batch_size=B, length=T, after=AFTER, steps=STEPS,
        cache_len=CACHE_LEN):
    """Both packages on the same inputs: prefill (logits, caches), ``after``
    decode steps from the prefill caches, the prompt replayed through an
    empty cache of the prompt's length, and ``steps`` greedy decode steps
    from an empty cache of ``cache_len`` (the port fed the reference's
    tokens).  Returns (reference, port) dicts."""
    return _run(arch, batch_size, length, after, steps, cache_len)


@functools.lru_cache(maxsize=None)
def _run(arch, batch_size, length, after, steps, cache_len):
    rcfg, cfg, p, tp = setup(arch)
    batch = inputs(cfg, batch_size, length)
    prefill_r, serve_r = _ref_steps(arch)
    prefill_p, serve_p = L.make_prefill_step(cfg), L.make_serve_step(cfg)
    tb = _port_batch(batch)
    ref, port = {}, {}
    lg, c = prefill_r(p, {k: jnp.asarray(v) for k, v in batch.items()})
    ref["prefill"], ref["prefill_cache"] = np.asarray(lg), \
        jax.tree_util.tree_map(np.asarray, c)
    tlg, tc = prefill_p(tp, tb)
    port["prefill"], port["prefill_cache"] = tlg, M.tree_map(
        lambda a: a.clone(), tc)
    # decode continuing from the prefill caches (cross-attention reads the
    # encoder's xk/xv there)
    tok = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
    ref["after"], port["after"] = [], []
    for i in range(after):
        pos = length + (cfg.num_patch_tokens if "patch_embeds" in batch else 0) + i
        nxt, lg, c = serve_r(p, c, tok, jnp.int32(pos))
        _, tlg, tc = serve_p(tp, tc, torch.as_tensor(np.array(tok)).long(),
                             pos)
        ref["after"].append(np.asarray(lg))
        port["after"].append(tlg)
        tok = nxt
    ref["after_cache"] = jax.tree_util.tree_map(np.asarray, c)
    port["after_cache"] = tc
    # the prompt replayed through an empty cache of its length
    toks = batch["tokens"]
    c = RM.init_cache(rcfg, batch_size, length)
    tc = M.init_cache(cfg, batch_size, length, device="cpu")
    for t in range(length):
        _, lg, c = serve_r(p, c, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        _, tlg, tc = serve_p(tp, tc, torch.as_tensor(toks[:, t:t + 1]).long(), t)
    ref["replay"], port["replay"] = np.asarray(lg), tlg
    # greedy decode from an empty cache
    c = RM.init_cache(rcfg, batch_size, cache_len)
    tc = M.init_cache(cfg, batch_size, cache_len, device="cpu")
    tok = jnp.asarray(toks[:, :1])
    ref["ids"], port["ids"], ref["decode"], port["decode"] = [], [], [], []
    for s in range(steps):
        nxt, lg, c = serve_r(p, c, tok, jnp.int32(s))
        tnxt, tlg, tc = serve_p(tp, tc, torch.as_tensor(np.array(tok)).long(),
                                s)
        ref["decode"].append(np.asarray(lg))
        port["decode"].append(tlg)
        ref["ids"].append(np.asarray(nxt))
        port["ids"].append(tnxt.numpy())
        tok = nxt
    ref["decode_cache"] = jax.tree_util.tree_map(np.asarray, c)
    port["decode_cache"] = tc
    return ref, port


def check_run(arch, tol=TOL, **kw):
    """Holds the port's run to the reference's (see :func:`run`) within
    ``tol``, and the port's prefill to its own replay within TOL."""
    ref, port = run(arch, **kw)
    close = lambda g, w, what: assert_close(g, w, what, tol)  # noqa: E731
    trees = lambda g, w, what: assert_trees_close(g, w, what, tol)  # noqa: E731
    close(port["prefill"], ref["prefill"], f"{arch} prefill logits")
    trees(port["prefill_cache"], ref["prefill_cache"], f"{arch} prefill caches")
    for i, (g, w) in enumerate(zip(port["after"], ref["after"])):
        close(g, w, f"{arch} decode {i} after prefill")
    trees(port["after_cache"], ref["after_cache"],
          f"{arch} caches after prefill + decode")
    close(port["replay"], ref["replay"], f"{arch} replay logits")
    if not setup(arch)[1].num_patch_tokens and \
            not setup(arch)[1].is_encoder_decoder:
        # prefill-then-decode == replay (the reference test's contract)
        assert_close(port["prefill"], port["replay"].numpy(),
                     f"{arch} prefill vs replay")
    for s, (g, w) in enumerate(zip(port["decode"], ref["decode"])):
        close(g, w, f"{arch} decode step {s}")
    for s, (g, w) in enumerate(zip(port["ids"], ref["ids"])):
        assert np.array_equal(g, w), f"{arch} greedy ids at step {s}"
    trees(port["decode_cache"], ref["decode_cache"],
          f"{arch} caches after decode")


def reference_spread(arch, rel=1e-7, draws=2, seed=0) -> float:
    """How far the reference's own prefill logits move when its embedding
    is perturbed by ``rel`` relative noise (float32 rounding's size): the
    floor below which no float32 implementation can be held to it."""
    rcfg, cfg, p, _ = setup(arch)
    batch = inputs(cfg, B, T)
    prefill = _ref_steps(arch)[0]
    feed = {k: jnp.asarray(v) for k, v in batch.items()}
    base = np.asarray(prefill(p, feed)[0])
    rng = np.random.default_rng(seed)
    worst = 0.0
    for _ in range(draws):
        e = np.asarray(p["embed"])
        q = dict(p, embed=jnp.asarray(
            (e * (1 + rel * rng.standard_normal(e.shape))).astype(np.float32)))
        worst = max(worst, rel_err(prefill(q, feed)[0], base))
    return worst
