"""Rotary position embeddings: standard RoPE and Qwen2-VL M-RoPE (port of
``repro/models/transformer/rope.py``).

M-RoPE [arXiv:2409.12191]: the head_dim/2 rotary frequency pairs are split
into (temporal, height, width) sections; section j rotates by positions[:, j].
For pure text, all three position streams are equal and M-RoPE reduces to
standard RoPE exactly.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                mrope_sections: Optional[Sequence[int]] = None) -> torch.Tensor:
    """positions: [B, T] (standard) or [B, 3, T] (M-RoPE) -> angles [B, T, hd/2]."""
    half = head_dim // 2
    inv_freq = _inv_freq(half, float(theta), positions.device)
    if mrope_sections is None:
        assert positions.dim() == 2, positions.shape
        return positions[:, :, None].float() * inv_freq[None, None, :]
    assert positions.dim() == 3 and positions.shape[1] == 3, positions.shape
    assert sum(mrope_sections) == half, (mrope_sections, half)
    j = torch.arange(half, device=positions.device)
    section_id = ((j >= mrope_sections[0]).long()
                  + (j >= mrope_sections[0] + mrope_sections[1]).long())
    # pick position stream per frequency pair: [B, half, T]
    pos = positions.float()[:, section_id, :]
    return pos.transpose(1, 2) * inv_freq[None, None, :]      # [B, T, half]


@functools.lru_cache(maxsize=None)
def _inv_freq(half: int, theta: float, device: torch.device) -> torch.Tensor:
    expo = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(theta, expo)


def rope_cos_sin(angles: torch.Tensor, dtype: torch.dtype):
    """The rotation of ``angles`` [B, T, hd/2] in ``dtype``, once for the
    queries and the keys of a block."""
    return (torch.cos(angles)[:, :, None, :].to(dtype),
            torch.sin(angles)[:, :, None, :].to(dtype))


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: [B, T, H, hd]; angles: [B, T, hd/2]. Rotates (first-half, second-half) pairs."""
    return rotate(x, *rope_cos_sin(angles, x.dtype))
