"""Attention: GQA/MHA/SWA, q-chunked (memory-bounded), KV cache + ring buffer
(port of ``repro/models/transformer/attention.py``).

Masking is entirely position-driven: every KV slot carries an absolute
position (``kv_pos``, -1 = empty), every query carries ``q_pos``.  The same
code therefore serves causal training, non-causal encoding, prefill,
single-token decode against a linear cache, and SWA decode against a
ring-buffer cache (where slot order is NOT position order).  The scores
are float32 whatever the inputs' dtype: q and k are widened before their
product, as the reference's ``preferred_element_type=jnp.float32`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

NEG_INF = -1e30

Position = Union[int, torch.Tensor]


def dot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                  causal: bool = True,
                  window: Optional[int] = None,
                  softcap: Optional[float] = None,
                  q_chunk: int = 512) -> torch.Tensor:
    """q: [B,T,H,dh]; k,v: [B,S,KV,dh]; q_pos: [B,T]; kv_pos: [B,S] -> [B,T,H,dh].

    Queries are processed in chunks of ``q_chunk`` so the materialized
    score tensor is [B, q_chunk, H, S] instead of [B, T, H, S].  Masking
    applies the cache's empty slots, then the causal term, then the
    window, after the softcap; a fully masked row comes out zero.
    """
    B, T, H, dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = dh ** -0.5
    kf = k.float()
    filled = (kv_pos >= 0)[:, None, None, None, :]
    kvp = kv_pos[:, None, None, None, :]

    def on_chunk(qc, qpc):
        c = qc.shape[1]
        qg = qc.reshape(B, c, KV, G, dh).float()
        scores = torch.einsum("btkgd,bskd->btkgs", qg, kf) * scale
        if softcap is not None:
            scores = torch.tanh(scores / softcap) * softcap
        mask = filled
        qp = qpc[:, :, None, None, None]
        if causal:
            mask = mask & (qp >= kvp)
        if window is not None:
            mask = mask & ((qp - kvp) < window)
        scores = torch.where(mask, scores, NEG_INF)
        p = torch.softmax(scores, dim=-1)
        p = torch.where(mask.any(dim=-1, keepdim=True), p, 0.0)  # fully-masked rows
        out = torch.einsum("btkgs,bskd->btkgd", p.to(v.dtype), v)
        return out.reshape(B, c, H, dh)

    if T <= q_chunk:
        return on_chunk(q, q_pos)
    return torch.cat([on_chunk(q[:, i:i + q_chunk], q_pos[:, i:i + q_chunk])
                      for i in range(0, T, q_chunk)], dim=1)


def row_positions(pos: Position, batch: int,
                  device: torch.device) -> torch.Tensor:
    """A decode position as one int64 per row: a scalar (every row at the
    same position, as ``decode_step``) is broadcast; a [B] tensor (each
    row its own sequence, as the scheduler's slots) is taken as it is."""
    p = torch.as_tensor(pos, device=device).long()
    return p.expand(batch) if p.dim() == 0 else p


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class KVCache:
    """Per-layer cache. ``ring=True`` (SWA) wraps writes modulo cache length.

    The model keeps one per block with every leaf stacked over the
    segment's units (``[count, B, ...]``); :meth:`update` writes unit u's
    view in place."""
    k: torch.Tensor        # [B, S, KV, dh]
    v: torch.Tensor        # [B, S, KV, dh]
    pos: torch.Tensor      # [B, S] int32 absolute positions, -1 = empty
    ring: bool = False

    @staticmethod
    def init(batch: int, length: int, kv_heads: int, head_dim: int,
             dtype=torch.bfloat16, ring: bool = False,
             device=None) -> "KVCache":
        return KVCache(
            k=torch.zeros((batch, length, kv_heads, head_dim), dtype=dtype,
                          device=device),
            v=torch.zeros((batch, length, kv_heads, head_dim), dtype=dtype,
                          device=device),
            pos=torch.full((batch, length), -1, dtype=torch.int32,
                           device=device),
            ring=ring)

    def update(self, k_new: torch.Tensor, v_new: torch.Tensor,
               pos: Position) -> "KVCache":
        """Insert one step in place. k_new/v_new: [B,1,KV,dh]; pos: a
        scalar, or [B] with each row's own position (slot ``pos % S`` on a
        ring, ``min(pos, S - 1)`` otherwise)."""
        B, S = self.k.shape[0], self.k.shape[1]
        p = row_positions(pos, B, self.k.device)
        idx = p % S if self.ring else torch.clamp(p, max=S - 1)
        rows = torch.arange(B, device=self.k.device)
        self.k[rows, idx] = k_new[:, 0].to(self.k.dtype)
        self.v[rows, idx] = v_new[:, 0].to(self.v.dtype)
        self.pos[rows, idx] = p.to(torch.int32)
        return self

    @staticmethod
    def from_prefill(k: torch.Tensor, v: torch.Tensor, length: int,
                     ring: bool = False) -> "KVCache":
        """Build a cache of ``length`` slots from full-sequence prefill k/v."""
        B, T = k.shape[0], k.shape[1]
        positions = torch.arange(T, dtype=torch.int32,
                                 device=k.device).expand(B, T)
        if T >= length:          # keep the trailing window
            k, v = k[:, T - length:], v[:, T - length:]
            positions = positions[:, T - length:]
            if ring:
                # place position p at slot p % length so future ring writes
                # evict oldest-first (slot order must equal p % length order)
                shift = (T - length) % length
                k = torch.roll(k, shift, dims=1)
                v = torch.roll(v, shift, dims=1)
                positions = torch.roll(positions, shift, dims=1)
            return KVCache(k=k.contiguous(), v=v.contiguous(),
                           pos=positions.contiguous(), ring=ring)
        pad = length - T
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        positions = torch.nn.functional.pad(positions, (0, pad), value=-1)
        return KVCache(k=k, v=v, pos=positions, ring=ring)
