"""Shared GNN pieces: masked-neighbor gather and mean (counterparts of
``repro/models/gnn/common.py``'s ``gather_neighbors``/``masked_mean``).

The hash dropout waits for the training slice: serving runs without it.
"""
from __future__ import annotations

import torch


def gather_neighbors(h_src: torch.Tensor, nbr_idx: torch.Tensor,
                     src_valid: torch.Tensor):
    """h_src [N_src, D]; nbr_idx [N_dst, f] (-1 pad) ->
    (feats [N_dst, f, D], mask [N_dst, f])."""
    idx = nbr_idx.clamp_min(0).long()
    feats = h_src[idx]
    mask = (nbr_idx >= 0) & src_valid[idx]
    return feats, mask


def masked_mean(feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """feats [N, f, D]; mask [N, f] -> [N, D] (zero where no neighbors)."""
    m = mask[..., None].to(feats.dtype)
    s = (feats * m).sum(dim=1)
    cnt = m.sum(dim=1)
    return s / cnt.clamp_min(1.0)
