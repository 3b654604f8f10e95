"""The port's continuous-batching scheduler (``repro_torch.serve.
scheduler``) against the reference's on the same weights and requests:
the reference's four ``tests/test_serving.py`` contracts, each held to the
ids the reference's own scheduler generates (and its step count), and an
MoE scheduler with more slots than E/K, where one routing group of all
slots would drop tokens the reference's per-slot ``vmap`` keeps.

The port's step is one decode with a position per slot; the reference's
a ``vmap`` of single-sequence decode.  Ids are held equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import setup
from repro.models.transformer import moe as RMoE
from repro.serve import scheduler as RS
from repro_torch.models.transformer import model as M
from repro_torch.models.transformer import moe
from repro_torch.serve import BatchScheduler, Request
from repro_torch.serve.scheduler import serve_requests


def both(arch, specs, num_slots, cache_len):
    """Serves ``specs`` (rid, prompt, max_tokens, eos) through both
    schedulers; returns ((reference requests, steps), (port requests,
    steps))."""
    rcfg, cfg, p, tp = setup(arch)
    rreqs = [RS.Request(rid=r, prompt=list(pr), max_tokens=n, eos_id=e)
             for r, pr, n, e in specs]
    treqs = [Request(rid=r, prompt=list(pr), max_tokens=n, eos_id=e)
             for r, pr, n, e in specs]
    ref = RS.serve_requests(rcfg, p, rreqs, num_slots=num_slots,
                            cache_len=cache_len)
    port = serve_requests(cfg, tp, treqs, num_slots=num_slots,
                          cache_len=cache_len, device="cpu")
    for a, b in zip(ref[0], port[0]):
        assert b.generated == a.generated, (b.rid, b.generated, a.generated)
        assert b.done == a.done
    assert port[1] == ref[1]
    return ref, port


def sequential(cfg, params, prompt, n, cache_len=32):
    """The port's single-sequence decode of one request (scalar
    positions): the contract the scheduler is held to."""
    cache = M.init_cache(cfg, 1, cache_len, device="cpu")
    tok = torch.tensor([[prompt[0]]])
    pos = 0
    for p in prompt[1:]:
        _, cache = M.decode_step(params, cfg, cache, tok, pos)
        tok = torch.tensor([[p]])
        pos += 1
    out = []
    for _ in range(n):
        logits, cache = M.decode_step(params, cfg, cache, tok, pos)
        tok = torch.argmax(logits[:, -1, :], -1)[:, None]
        out.append(int(tok[0, 0]))
        pos += 1
    return out


def test_scheduler_matches_sequential():
    _, cfg, _, tp = setup("minitron-4b")
    prompt = [3, 7, 11]
    (_, _), (port, _) = both("minitron-4b", [(0, prompt, 4, None)],
                             num_slots=2, cache_len=32)
    assert port[0].generated == sequential(cfg, tp, prompt, 4)
    sched = BatchScheduler(cfg, M.TransformerLM(cfg, tp), 2, 32, device="cpu")
    req = Request(rid=0, prompt=list(prompt), max_tokens=4)
    sched.submit(req)
    assert sched.run() == 6 and req.generated == port[0].generated


def test_more_requests_than_slots():
    specs = [(i, [i + 1, i + 2], 3, None) for i in range(5)]
    (_, _), (port, steps) = both("minitron-4b", specs, num_slots=2,
                                 cache_len=16)
    assert all(r.done for r in port)
    assert all(len(r.generated) == 3 for r in port)
    assert steps >= 3 * 3


def test_slot_reuse_is_isolated():
    (_, _), (a, _) = both("minitron-4b", [(0, [5, 9], 3, None)],
                          num_slots=1, cache_len=16)
    (_, _), (pair, _) = both("minitron-4b", [(1, [2, 4], 3, None),
                                             (2, [5, 9], 3, None)],
                             num_slots=1, cache_len=16)
    assert pair[1].generated == a[0].generated


def test_eos_frees_slot():
    (_, _), (probe, _) = both("minitron-4b", [(0, [1, 2], 5, None)],
                              num_slots=1, cache_len=16)
    eos = probe[0].generated[0]
    (_, _), (r, _) = both("minitron-4b", [(1, [1, 2], 5, eos)],
                          num_slots=1, cache_len=16)
    assert r[0].done and r[0].generated == [eos]


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "recurrentgemma-9b"])
def test_scheduler_with_more_slots_than_experts_per_choice(arch):
    """Six slots (mixtral reduced: E/K = 4/2 = 2; recurrentgemma's RG-LRU
    states and local-attention ring), eight requests of unequal prompts,
    so slots are reused at different positions: the reference's ids."""
    specs = [(i, [(7 * i + j) % 97 + 1 for j in range(2 + i % 3)], 4, None)
             for i in range(8)]
    both(arch, specs, num_slots=6, cache_len=24)


def test_moe_routes_each_slot_alone():
    """Per-row routing is the reference's vmap of a single token: at six
    tokens in one group (C = max(4, ceil(6 * 2 / 4 * 1.25)) = 4) an
    expert chosen by more than four is over capacity, while each row
    alone (C = 4 for 2 choices) never is."""
    rcfg, cfg, p, tp = setup("mixtral-8x7b")
    rng = np.random.default_rng(6)
    x = rng.normal(size=(6, 1, cfg.d_model)).astype(np.float32)
    router = np.zeros((cfg.d_model, cfg.num_experts), np.float32)
    router[:, 0] = 1.0                          # every token picks expert 0
    mp = {k: v[0] for k, v in tp["seg0"]["b0"]["moe"].items()}
    mp["router"] = torch.as_tensor(router)
    rmp = jax.tree_util.tree_map(lambda a: a[0], p["seg0"]["b0"]["moe"])
    rmp["router"] = jnp.asarray(router)
    x = np.abs(x)                               # positive logits for expert 0
    want = np.asarray(jax.vmap(lambda r: RMoE.apply_moe(rmp, r[None], rcfg)[0])(
        jnp.asarray(x)))
    got = moe.apply_moe(mp, torch.as_tensor(x), cfg, per_row=True)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * max(1, np.abs(want).max())
    grouped = moe.apply_moe(mp, torch.as_tensor(x).reshape(1, 6, -1), cfg)
    assert moe.capacity(6, cfg) == 4
    assert not torch.allclose(grouped.reshape(6, 1, -1), got)
