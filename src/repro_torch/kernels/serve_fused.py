"""Fused serve layer: gather + masked mean + ``agg@Wn + self@Ws + b``
(+ReLU) in one CUDA kernel (``csrc/serve_fused.cu``).

Replaces the TPU kernel ``repro/kernels/serve_fused.py:fused_serve_layer``.
Online serving runs one launch per GNN layer; the offline layer-wise
engine runs one per dst chunk, passing ``self_idx`` because a chunk's
self rows are ``h_all[dst]`` and not a prefix.  The kernel gathers by
warps and runs both products on the tensor cores (3xTF32), in a block
form :func:`serve_tile` picks from the shape and the SM count.

The wrapper launches the kernel for CUDA tensors and runs the plain
version ``serve_layer_ref`` (re-exported here) for CPU tensors; there is
no fallback between the two.  ``serve_fused_layer.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import serve_layer_ref

__all__ = ["serve_fused_layer", "serve_layer_ref", "serve_tile",
           "serve_form", "smem_bytes", "SMEM_LIMIT"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"serve_fused_layer": ([_P] * 8 + [_I] * 8 + [_P], _I),
               "serve_fused_smem": ([_I, _I], _I)}
SMEM_LIMIT = 232448              # bytes of shared memory a Hopper block may use
# csrc/serve_fused.cu's tiling: block rows, output columns per column tile,
# depth and padded row of a staged weight tile, and the warps' gather lists
BMS = (64, 32, 16)
BN, BK, STAGES, B_LD = 64, 32, 2, 72
WARPS, LIST = 8, 4 * 32 + 4


def smem_bytes(bm: int, D: int) -> int:
    """Dynamic shared memory of a block of ``bm`` rows at depth ``D``: the
    gathered neighbor means and self rows (rows padded to D rounded up to
    32, plus 4), the weight ring, and one region for the warps' gather
    lists and then the first product's stash (``serve_fused_smem`` in the
    source)."""
    dk = -(-D // BK) * BK
    return 4 * (2 * bm * (dk + 4) + STAGES * BK * B_LD
                + max(bm * BN, WARPS * LIST * 2))


def serve_tile(M: int, K: int, D: int, sms: int):
    """Kernel A's block form for ``M`` rows, ``K`` output columns and depth
    ``D`` on a card of ``sms`` SMs: ``(rows, column tiles)`` per block.

    A block owns every 64-column tile of its rows (each row gathered once)
    with the most rows whose grid still covers the SMs; where none does,
    it owns one column tile, with the most rows that cover them; at the
    smallest M, 16 rows and one column tile (the most blocks there are).
    Only row counts whose shared memory fits a block are taken."""
    fits = [bm for bm in BMS if smem_bytes(bm, D) <= SMEM_LIMIT]
    if not fits:
        raise ValueError(f"D={D} needs more shared memory than a block has")
    tiles = -(-K // BN)
    for bm in fits:
        if -(-M // bm) >= sms:
            return bm, tiles
    for bm in fits:
        if -(-M // bm) * tiles >= sms:
            return bm, 1
    return fits[-1], 1


def serve_form(M: int, K: int, D: int, sms: int) -> str:
    """The form :func:`serve_tile` picks, as ``chip_smoke.py`` prints it."""
    bm, tiles = serve_tile(M, K, D, sms)
    kt = -(-K // BN)
    blocks = -(-M // bm) * -(-kt // tiles)
    cols = "all columns" if tiles == kt else f"{tiles * BN} columns"
    return f"3xTF32 {bm} rows x {cols}, {blocks} blocks"


def serve_fused_layer(h_src: torch.Tensor, nbr_idx: torch.Tensor,
                      src_valid: torch.Tensor, wn: torch.Tensor,
                      ws: torch.Tensor, b: torch.Tensor, *, relu: bool = True,
                      self_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One serve layer: h_src [N, D] f32; nbr_idx [M, f] int32 (-1 pad);
    src_valid [N] bool; wn/ws [D, K] f32; b [K] f32; self_idx [M] int32
    or None (then self rows are ``h_src[:M]``) -> [M, K] f32."""
    if h_src.device.type == "cpu":
        return serve_layer_ref(h_src, nbr_idx, src_valid, wn, ws, b,
                               relu=relu, self_idx=self_idx)
    if h_src.device.type != "cuda":
        raise ValueError(f"serve_fused_layer: unsupported device "
                         f"{h_src.device}")
    dev = h_src.device
    if h_src.dim() != 2 or nbr_idx.dim() != 2 or wn.dim() != 2:
        raise ValueError("h_src, nbr_idx and wn must be 2-D")
    N, D = h_src.shape
    M, f = nbr_idx.shape
    K = wn.shape[1]
    _build.check_tensor("h_src", h_src, torch.float32, (N, D), dev)
    _build.check_tensor("nbr_idx", nbr_idx, torch.int32, (M, f), dev)
    _build.check_tensor("src_valid", src_valid, torch.bool, (N,), dev)
    _build.check_tensor("wn", wn, torch.float32, (D, K), dev)
    _build.check_tensor("ws", ws, torch.float32, (D, K), dev)
    _build.check_tensor("b", b, torch.float32, (K,), dev)
    if self_idx is not None:
        _build.check_tensor("self_idx", self_idx, torch.int32, (M,), dev)
    elif M > N:
        raise ValueError(f"self rows are the h_src[:M] prefix, but M={M} > "
                         f"N={N}; pass self_idx")
    if N == 0 and M > 0:
        raise ValueError("h_src has no rows to gather from")
    bm, tiles = serve_tile(M, K, D, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    out = torch.empty((M, K), dtype=torch.float32, device=dev)
    if M == 0 or K == 0:
        return out
    lib = _build.load("serve_fused", _SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.serve_fused_layer(
            h_src.data_ptr(), nbr_idx.data_ptr(), src_valid.data_ptr(),
            wn.data_ptr(), ws.data_ptr(), b.data_ptr(),
            None if self_idx is None else self_idx.data_ptr(),
            out.data_ptr(), N, M, f, D, K, int(relu), bm, tiles, stream)
    if rc != 0:
        raise RuntimeError(f"serve_fused_layer: launch failed with CUDA "
                           f"error {rc}")
    serve_fused_layer.launches += 1
    return out


serve_fused_layer.launches = 0
