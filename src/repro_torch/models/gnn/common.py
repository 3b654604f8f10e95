"""Shared GNN pieces: masked-neighbor gather and mean, and the
deterministic position-hash dropout (counterparts of
``repro/models/gnn/common.py``).

The dropout mask is a hash of the global (row, col) position and a u32
seed, so the CUDA kernels and these torch ops draw bit-identical masks
from the same seed, and both match the reference.  torch has no uint32
shift or remainder on the CPU, so the u32 arithmetic is emulated in int64
with ``& 0xFFFFFFFF`` after each multiply: an int64 product that wraps
still has the right low 32 bits.
"""
from __future__ import annotations

import torch

_MIX1 = 0x85EBCA6B
_MIX2 = 0xC2B2AE35
_U32 = 0xFFFFFFFF


def gather_neighbors(h_src: torch.Tensor, nbr_idx: torch.Tensor,
                     src_valid: torch.Tensor):
    """h_src [N_src, D]; nbr_idx [N_dst, f] (-1 pad) ->
    (feats [N_dst, f, D], mask [N_dst, f]).  An index past the last row
    reads the last row, as jnp's gather clamps."""
    idx = nbr_idx.long().clamp(0, max(h_src.shape[0] - 1, 0))
    feats = h_src[idx]
    mask = (nbr_idx >= 0) & src_valid[idx]
    return feats, mask


def masked_mean(feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """feats [N, f, D]; mask [N, f] -> [N, D] (zero where no neighbors)."""
    m = mask[..., None].to(feats.dtype)
    s = (feats * m).sum(dim=1)
    cnt = m.sum(dim=1)
    return s / cnt.clamp_min(1.0)


def hash_uniform(seed: int, rows: torch.Tensor,
                 cols: torch.Tensor) -> torch.Tensor:
    """Uniforms in [0, 1) from (seed, row, col): [len(rows), len(cols)]
    float32, bit-exact to the reference's u32 mix hash."""
    r = (rows.long() & _U32) * _MIX1 & _U32
    c = (cols.long() & _U32) * _MIX2 & _U32
    h = r[:, None] ^ c[None, :] ^ (int(seed) & _U32)
    h = h ^ (h >> 15)
    h = h * _MIX1 & _U32
    h = h ^ (h >> 13)
    return (h >> 8).to(torch.float32) / float(1 << 24)


def f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-dim float32 tensor on ``like``'s device.  Dividing by
    it is a true float32 division on every device (a CPU scalar divisor
    makes CUDA multiply by its reciprocal instead)."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def hash_dropout(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """x [N, D]; keeps ``u >= rate`` and divides by ``1 - rate``."""
    if rate <= 0.0:
        return x
    dev = x.device
    u = hash_uniform(seed, torch.arange(x.shape[0], device=dev),
                     torch.arange(x.shape[1], device=dev))
    keep = u >= f32(rate, x)
    return torch.where(keep, x / f32(1.0 - rate, x), f32(0.0, x))
