"""Mixture-of-Experts FFN with top-k routing and capacity-bounded dispatch
(port of ``repro/models/transformer/moe.py``).

Two dispatch implementations, selectable via ``cfg.moe_impl``:

* ``einsum`` — GShard/Switch-style one-hot dispatch/combine tensors of shape
  [groups, group_size, experts, capacity];
* ``gather`` — scatter slot assignment + gathers; no one-hot tensors.

Tokens are routed in groups of ``cfg.moe_group_size`` over the flattened
batch, and each group has a capacity ``C`` per expert.  ``per_row=True``
groups each batch row on its own: the scheduler's decode, which the
reference runs as a ``vmap`` of single-sequence decode, so every slot is
a group of one token (S = 1, C = 4, nothing dropped) whatever the number
of slots.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.transformer.xlstm import silu


def one_hot(idx, n, dtype):
    """``jax.nn.one_hot``: an index outside [0, n) gives a zero row (a
    comparison, so no bounds check waits for the device)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _route(router, x, top_k):
    """x: [G,S,d] -> (gates [G,S,k], expert_idx [G,S,k]).

    The router logits are float32; top-k keeps the lower expert index on
    ties, as ``jax.lax.top_k`` does (a stable descending sort)."""
    logits = x.float() @ router.to(x.dtype).float()
    top_vals, top_idx = torch.sort(logits, dim=-1, descending=True,
                                   stable=True)
    top_vals, top_idx = top_vals[..., :top_k], top_idx[..., :top_k]
    gates = torch.softmax(top_vals, dim=-1)          # mixtral-style renorm
    return gates.to(x.dtype), top_idx


def _positions_in_expert(expert_idx, num_experts):
    """Slot order: all tokens' k=0 choices first, then k=1 (GShard priority).

    expert_idx: [G,S,K] -> pos [G,S,K] (occupancy rank within each expert).
    """
    G, S, K = expert_idx.shape
    flat = expert_idx.transpose(1, 2).reshape(G, K * S)       # [G, K*S] k-major
    onehot = one_hot(flat, num_experts, torch.long)           # [G,KS,E]
    pos_flat = torch.cumsum(onehot, dim=1) - 1
    pos_flat = torch.gather(pos_flat, 2, flat[..., None])[..., 0]
    return pos_flat.reshape(G, K, S).transpose(1, 2)          # [G,S,K]


def _expert_ffn(xe, params, act_dtype):
    """xe: [G,E,C,d] -> [G,E,C,d]."""
    w_in = params["w_in"].to(act_dtype)
    w_gate = params["w_gate"].to(act_dtype)
    w_out = params["w_out"].to(act_dtype)
    h = torch.einsum("gecd,edf->gecf", xe, w_in)
    g = silu(torch.einsum("gecd,edf->gecf", xe, w_gate))
    return torch.einsum("gecf,efd->gecd", h * g, w_out)


def capacity(S: int, cfg) -> int:
    C = int(math.ceil(S * cfg.top_k / cfg.num_experts * cfg.capacity_factor))
    return max(4, ((C + 3) // 4) * 4)


def apply_moe(params, x, cfg, per_row: bool = False):
    """x: [B,T,d] -> [B,T,d]."""
    B, T, d = x.shape
    rows = B if per_row else 1
    N = B * T // rows                      # tokens routed together
    S = min(cfg.moe_group_size, N)
    pad = (-N) % S
    xf = x.reshape(rows, N, d)
    if pad:
        xf = F.pad(xf, (0, 0, 0, pad))
    G = rows * (xf.shape[1] // S)
    xg = xf.reshape(G, S, d)

    E, K = cfg.num_experts, cfg.top_k
    C = capacity(S, cfg)

    gates, expert_idx = _route(params["router"], xg, K)       # [G,S,K]
    pos = _positions_in_expert(expert_idx, E)                 # [G,S,K]
    keep = pos < C

    if cfg.moe_impl == "einsum":
        out = _dispatch_einsum(params, xg, gates, expert_idx, pos, keep, E, C)
    elif cfg.moe_impl == "gather":
        out = _dispatch_gather(params, xg, gates, expert_idx, pos, keep, E, C)
    else:
        raise ValueError(cfg.moe_impl)

    out = out.reshape(rows, -1, d)
    if pad:
        out = out[:, :N]
    return out.reshape(B, T, d)


def _dispatch_einsum(params, xg, gates, expert_idx, pos, keep, E, C):
    """GShard-style one-hot dispatch/combine."""
    # [G,S,K,E] x [G,S,K,C] -> combine [G,S,E,C]
    oh_e = one_hot(expert_idx, E, xg.dtype)
    oh_c = one_hot(torch.where(keep, pos, C), C, xg.dtype)   # ==0 if dropped
    combine = torch.einsum("gske,gskc,gsk->gsec", oh_e, oh_c, gates)
    dispatch = torch.einsum("gske,gskc->gsec", oh_e, oh_c)
    xe = torch.einsum("gsec,gsd->gecd", dispatch, xg)
    ye = _expert_ffn(xe, params, xg.dtype)
    return torch.einsum("gsec,gecd->gsd", combine, ye)


def _dispatch_gather(params, xg, gates, expert_idx, pos, keep, E, C):
    """Scatter/gather dispatch — no [G,S,E,C] one-hots."""
    G, S, d = xg.shape
    K = expert_idx.shape[-1]
    dev = xg.device
    # slot_token[g,e,c] = s of the token occupying that slot (S = empty sentinel)
    g_ix = torch.arange(G, device=dev)[:, None, None].expand(G, S, K)
    s_ix = torch.arange(S, device=dev)[None, :, None].expand(G, S, K)
    c_ix = torch.where(keep, pos, C)     # dropped -> scatter into overflow col
    slot_token = torch.full((G, E, C + 1), S, dtype=torch.long, device=dev)
    slot_token[g_ix, expert_idx, c_ix] = s_ix
    slot_token = slot_token[..., :C]                                 # [G,E,C]
    # gather tokens into expert slots (padded row S reads zeros)
    xpad = torch.cat([xg, torch.zeros((G, 1, d), dtype=xg.dtype, device=dev)],
                     dim=1)
    xe = torch.gather(xpad, 1, slot_token.reshape(G, E * C, 1).expand(-1, -1, d))
    ye = _expert_ffn(xe.reshape(G, E, C, d), params, xg.dtype)
    # gather results back to tokens
    flat = ye.reshape(G, E * C, d)
    idx = (expert_idx * C + torch.clamp(pos, max=C - 1)).reshape(G, S * K)
    y_k = torch.gather(flat, 1, idx[..., None].expand(-1, -1, d))
    y_k = y_k.reshape(G, S, K, d) * torch.where(
        keep, gates, torch.zeros((), dtype=gates.dtype, device=dev))[..., None]
    return y_k.sum(dim=2)


def moe_aux_loss(params, x, cfg):
    """Load-balance auxiliary loss (Switch): E * sum_e f_e * p_e, over the
    whole batch as one group (the reference's train step does not call
    it either)."""
    B, T, d = x.shape
    xg = x.reshape(1, B * T, d)
    logits = xg.float() @ params["router"].to(x.dtype).float()
    probs = torch.softmax(logits, dim=-1)
    _, top_idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    frac = one_hot(top_idx[..., :cfg.top_k], cfg.num_experts,
                   torch.float32).sum(2).mean(dim=(0, 1))
    return cfg.num_experts * torch.sum(frac * probs.mean(dim=(0, 1)))
