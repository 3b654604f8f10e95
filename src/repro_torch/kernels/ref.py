"""Plain PyTorch versions of the port's kernels.

Each function computes what its CUDA kernel computes, with torch ops.  The
kernel wrappers run them for tensors on the CPU, the CPU tests hold them
against the JAX reference, and ``chip_smoke.py`` holds each kernel
against its plain version on the card.  On the card they are a
correctness yardstick, not a speed one.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.gnn.common import gather_neighbors, masked_mean

_MIX = 0x9E3779B1          # Fibonacci hashing multiplier of the HEC layout
_U32 = 0xFFFFFFFF


def serve_layer_ref(h_src: torch.Tensor, nbr_idx: torch.Tensor,
                    src_valid: torch.Tensor, wn: torch.Tensor,
                    ws: torch.Tensor, b: torch.Tensor, *, relu: bool = True,
                    self_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One serve layer: gather + masked mean + ``agg@Wn + self@Ws + b``
    (+ReLU); ``repro.kernels.ref.serve_layer_ref`` op for op.

    h_src [N, D]; nbr_idx [M, f] (-1 pad); src_valid [N] bool;
    wn/ws [D, K]; b [K]; self_idx [M] (default: the ``h_src[:M]`` prefix,
    clamped to ``[0, N)`` like the reference's ``jnp.clip``) -> [M, K].
    """
    feats, mask = gather_neighbors(h_src, nbr_idx, src_valid)
    agg = masked_mean(feats, mask)
    M = nbr_idx.shape[0]
    if self_idx is None:
        self_h = h_src[:M]
    else:
        self_h = h_src[self_idx.long().clamp(0, h_src.shape[0] - 1)]
    out = agg @ wn + self_h @ ws + b
    return torch.relu(out) if relu else out


def set_index(vids: torch.Tensor, nsets: int) -> torch.Tensor:
    """VID -> HEC set: ``((u32)vid * 0x9E3779B1 >> 8) % nsets`` (int64).

    u32 arithmetic emulated in int64, since torch has no uint32 shift or
    remainder on the CPU: a negative vid is first taken mod 2^32, as the
    reference's ``astype(uint32)`` does, and the product is formed from
    16-bit halves so that no intermediate leaves int64."""
    v = vids.long() & _U32
    lo, hi = v & 0xFFFF, v >> 16
    prod = (lo * _MIX + (((hi * _MIX) & 0xFFFF) << 16)) & _U32
    return (prod >> 8) % nsets


def hec_lookup_ref(tags: torch.Tensor, values: torch.Tensor,
                   vids: torch.Tensor):
    """HECSearch + HECLoad: vids [n] -> (hit [n] bool, set [n] int32,
    way [n] int32, emb [n, d] with misses zeroed).

    ``way`` is the first way whose tag equals the vid (0 if none); a
    negative vid never hits.  Same outputs as the reference's
    ``hec_search_kernel`` followed by ``hec_load`` and the miss mask."""
    nsets = tags.shape[0]
    s = set_index(vids, nsets)
    match = tags[s] == vids[:, None].to(tags.dtype)
    hit = match.any(dim=1) & (vids >= 0)
    way = match.to(torch.int32).argmax(dim=1)
    emb = torch.where(hit[:, None], values[s, way],
                      torch.zeros((), dtype=values.dtype,
                                  device=values.device))
    return hit, s.to(torch.int32), way.to(torch.int32), emb
