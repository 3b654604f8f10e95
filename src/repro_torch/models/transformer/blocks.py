"""Attention-family transformer blocks (global GQA / SWA / local / +MoE FFN,
optional cross-attention for enc-dec decoders); port of
``repro/models/transformer/blocks.py``."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs import base as cfgbase
from repro_torch.models.transformer import moe as moe_lib
from repro_torch.models.transformer.attention import (KVCache, dot_attention,
                                                      row_positions)
from repro_torch.models.transformer.rope import (rope_angles, rope_cos_sin,
                                                 rotate)
from repro_torch.models.transformer.xlstm import rms_norm, silu


def block_window(cfg, block_type: str) -> Optional[int]:
    if block_type in (cfgbase.ATTN_SWA, cfgbase.ATTN_SWA_MOE):
        return cfg.sliding_window
    if block_type == cfgbase.LOCAL_ATTN:
        return cfg.local_window
    return None


def _proj(x, w, dt):
    """einsum("btd,dhk->bthk", x, w) in ``dt``."""
    B, T, _ = x.shape
    return (x @ w.to(dt).reshape(w.shape[0], -1)).reshape(B, T, *w.shape[1:])


def _out(a, w, dt):
    """einsum("bthk,hkd->btd", a, w) in ``dt``."""
    B, T = a.shape[:2]
    return a.reshape(B, T, -1) @ w.to(dt).reshape(-1, w.shape[-1])


def _qkv(params, xn, cfg, prefix=""):
    dt = xn.dtype
    q = _proj(xn, params[prefix + "wq"], dt)
    k = _proj(xn, params[prefix + "wk"], dt)
    v = _proj(xn, params[prefix + "wv"], dt)
    if cfg.use_bias and not prefix:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    return q, k, v


def _ffn(params, x, cfg, block_type, per_row=False):
    if block_type in cfgbase.MOE_BLOCKS:
        return moe_lib.apply_moe(params["moe"], x, cfg, per_row=per_row)
    dt = x.dtype
    h = x @ params["w_in"].to(dt)
    g = silu(x @ params["w_gate"].to(dt))
    return (h * g) @ params["w_out"].to(dt)


def apply_attn_block(params, x, cfg, block_type, positions, mode,
                     cache=None, pos=None, enc_out=None, causal=True):
    """x: [B,T,d]. Returns (y, new_cache).

    mode: train | encode (no cache) | prefill (build cache) | decode (use it).
    cache: {"kv": KVCache, ["xk","xv" for cross]} or None; decode writes
    the new token into ``cache["kv"]`` in place.  In decode ``pos`` is a
    scalar (every row at one position: ``decode_step``) or a [B] tensor
    (each row its own sequence: the scheduler's slots, where an MoE FFN
    also routes each row as its own group).
    """
    B, T, d = x.shape
    dt = x.dtype
    window = block_window(cfg, block_type)
    xn = rms_norm(x, params["ln1"], cfg.norm_eps)
    q, k, v = _qkv(params, xn, cfg)

    angles = rope_angles(positions, cfg.head_dim, cfg.rope_theta,
                         cfg.mrope_sections)
    cos, sin = rope_cos_sin(angles, dt)
    q, k = rotate(q, cos, sin), rotate(k, cos, sin)
    new_cache = dict(cache) if cache is not None else None
    per_row = False
    if mode == "decode":
        kv: KVCache = cache["kv"]
        kv = kv.update(k, v, pos)
        new_cache["kv"] = kv
        q_pos = row_positions(pos, B, x.device)[:, None].to(torch.int32)
        per_row = torch.is_tensor(pos) and pos.dim() == 1
        attn = dot_attention(q, kv.k, kv.v, q_pos, kv.pos, causal=True,
                             window=window, softcap=cfg.attn_logit_softcap,
                             q_chunk=cfg.q_chunk)
    else:
        q_pos = positions if positions.dim() == 2 else positions[:, 0]
        q_pos = q_pos.to(torch.int32)
        attn = dot_attention(q, k, v, q_pos, q_pos,
                             causal=causal and mode != "encode", window=window,
                             softcap=cfg.attn_logit_softcap, q_chunk=cfg.q_chunk)
        if mode == "prefill":
            cache_len = min(T, window) if window else T
            new_cache = new_cache or {}
            new_cache["kv"] = KVCache.from_prefill(k, v, cache_len,
                                                   ring=window is not None)

    x = x + _out(attn, params["wo"], dt)

    # cross-attention (enc-dec decoder)
    if "xwq" in params:
        xn2 = rms_norm(x, params["lnx"], cfg.norm_eps)
        qx = _proj(xn2, params["xwq"], dt)
        if mode == "decode":
            kx, vx = cache["xk"], cache["xv"]
        else:
            kx = _proj(enc_out.to(dt), params["xwk"], dt)
            vx = _proj(enc_out.to(dt), params["xwv"], dt)
            if mode == "prefill":
                new_cache["xk"], new_cache["xv"] = kx, vx
        S = kx.shape[1]
        qp = torch.zeros((B, qx.shape[1]), dtype=torch.int32, device=x.device)
        kp = torch.zeros((B, S), dtype=torch.int32, device=x.device)
        xattn = dot_attention(qx, kx, vx, qp, kp, causal=False,
                              q_chunk=cfg.q_chunk)
        x = x + _out(xattn, params["xwo"], dt)

    # FFN / MoE
    xn3 = rms_norm(x, params["ln2"], cfg.norm_eps)
    x = x + _ffn(params, xn3, cfg, block_type, per_row=per_row)
    return x, new_cache


def init_attn_cache(cfg, batch, cache_len, block_type, dtype,
                    cross_len: int = 0, device=None):
    window = block_window(cfg, block_type)
    length = min(cache_len, window) if window else cache_len
    c = {"kv": KVCache.init(batch, length, cfg.num_kv_heads, cfg.head_dim,
                            dtype, ring=window is not None, device=device)}
    if cross_len:
        shape = (batch, cross_len, cfg.num_kv_heads, cfg.head_dim)
        c["xk"] = torch.zeros(shape, dtype=dtype, device=device)
        c["xv"] = torch.zeros(shape, dtype=dtype, device=device)
    return c
