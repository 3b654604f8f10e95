"""GAT AGG, the edge softmax and the alpha-weighted sum of neighbor rows,
as CUDA kernels (``csrc/gat_edge.cu``): the forward (kernel G) and its
gradient with respect to ``z``, ``e_u`` and ``e_v`` (kernel H).

Replaces the TPU kernel ``repro/kernels/gat_edge.py:gat_edge`` with the
gather of ``repro/kernels/ops.py:gat_edge_aggregate`` folded in: the
kernels read ``z[nbr]`` and ``e_u[nbr]`` themselves, so no ``[M, f, H *
dh]`` tensor is made.  :func:`gat_edge_aggregate` is differentiable: a
``torch.autograd.Function`` whose backward launches kernel H, which
recomputes the softmax from ``e_u``/``e_v`` (the forward keeps no
``[M, f, H]`` tensor).  Kernel G takes one of three forms by shape
(:func:`fwd_plan`): a warp per row ("row"), a warp per part of a row's
columns ("split", where M rows alone cannot fill the card), or, for rows
of hundreds of slots, the first version's chunked form ("chunked").

The wrappers launch the kernels for CUDA tensors and run the plain
versions ``gat_edge_ref``/``gat_edge_bwd_ref`` (re-exported here) for CPU
tensors; there is no fallback between the two.  ``.launches`` on each
wrapper counts its kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import gat_edge_bwd_ref, gat_edge_ref

__all__ = ["gat_edge_aggregate", "gat_edge_fwd", "gat_edge_bwd",
           "gat_edge_ref", "gat_edge_bwd_ref", "fwd_plan"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "gat_edge_fwd": ([_P] * 7 + [_I] * 8 + [_P], _I),
    "gat_edge_bwd": ([_P] * 11 + [_I] * 6 + [_P], _I),
}


def _check(z, e_u, e_v, nbr_idx, src_valid, dst_idx):
    """Raise unless the operands are what the kernels take; returns
    (N, Nev, M, f, H, dh)."""
    if z.dim() != 3 or nbr_idx.dim() != 2 or e_v.dim() != 2:
        raise ValueError("z must be [N, H, dh], nbr_idx [M, f], e_v [Nev, H]")
    dev = z.device
    N, H, dh = z.shape
    M, f = nbr_idx.shape
    Nev = e_v.shape[0]
    f32 = torch.float32
    _build.check_tensor("z", z, f32, (N, H, dh), dev)
    _build.check_tensor("e_u", e_u, f32, (N, H), dev)
    _build.check_tensor("e_v", e_v, f32, (Nev, H), dev)
    _build.check_tensor("nbr_idx", nbr_idx, torch.int32, (M, f), dev)
    _build.check_tensor("src_valid", src_valid, torch.bool, (N,), dev)
    if dst_idx is None:
        if Nev < M:
            raise ValueError(f"e_v has {Nev} rows for {M} dst rows "
                             f"(the prefix form needs one per row)")
    else:
        _build.check_tensor("dst_idx", dst_idx, torch.int32, (M,), dev)
        if Nev == 0 and M:
            raise ValueError("dst_idx needs a non-empty e_v")
    return N, Nev, M, f, H, dh


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


MAX_WARPS = 8                   # warps per block of kernel G
SMEM_LIMIT = 48 * 1024          # bytes of shared memory per block


def fwd_plan(M: int, f: int, H: int, dh: int, vec: bool, sms: int):
    """Kernel G's form at these shapes: ``(route, cw)``, ``cw`` the column
    part in vector columns (float4 with ``vec``, else float), 0 for the
    chunked form.  The one-pass form holds a row's ``f * H`` logits in
    shared memory; it cuts a row's columns into parts of ``cw`` (a
    multiple of 32) until ``M`` x parts warps reach 64 per SM (the most
    an SM holds) or a part is one warp wide."""
    per_warp = -(-(f * H + 2 * f + 2 * H) // 4) * 4
    if MAX_WARPS * per_warp * 4 > SMEM_LIMIT:
        return "chunked", 0
    hdv = H * (dh // 4 if vec else dh)
    cw = -(-hdv // 32) * 32
    while cw > 32 and M * -(-hdv // cw) < 64 * sms:
        cw = -(-(cw // 2) // 32) * 32
    return ("row" if cw >= hdv else "split"), cw


def gat_edge_fwd(z: torch.Tensor, e_u: torch.Tensor, e_v: torch.Tensor,
                 nbr_idx: torch.Tensor, src_valid: torch.Tensor,
                 dst_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel G: z [N, H, dh] f32; e_u [N, H]; e_v [Nev, H]; nbr_idx
    [M, f] int32 (-1 pad); src_valid [N] bool; dst_idx [M] int32 or None
    (row m reads ``e_v[m]``) -> [M, H * dh]."""
    if z.device.type == "cpu":
        return gat_edge_ref(z, e_u, e_v, nbr_idx, src_valid, dst_idx)
    if z.device.type != "cuda":
        raise ValueError(f"gat_edge_fwd: unsupported device {z.device}")
    N, Nev, M, f, H, dh = _check(z, e_u, e_v, nbr_idx, src_valid, dst_idx)
    out = torch.empty((M, H * dh), dtype=torch.float32, device=z.device)
    if M == 0 or H * dh == 0:
        return out.zero_()
    lib = _build.load("gat_edge", _SIGNATURES)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    vec = dh % 4 == 0 and z.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    _, cw = fwd_plan(M, f, H, dh, vec, torch.cuda.get_device_properties(
        z.device).multi_processor_count)
    with torch.cuda.device(z.device):
        rc = lib.gat_edge_fwd(z.data_ptr(), e_u.data_ptr(), e_v.data_ptr(),
                              nbr_idx.data_ptr(), src_valid.data_ptr(),
                              _ptr(dst_idx), out.data_ptr(), N, Nev, M, f, H,
                              dh, cw, int(vec), stream)
    if rc != 0:
        raise RuntimeError(f"gat_edge_fwd: launch failed with CUDA error {rc}")
    gat_edge_fwd.launches += 1
    return out


gat_edge_fwd.launches = 0


def gat_edge_bwd(g: torch.Tensor, z: torch.Tensor, e_u: torch.Tensor,
                 e_v: torch.Tensor, nbr_idx: torch.Tensor,
                 src_valid: torch.Tensor,
                 dst_idx: Optional[torch.Tensor] = None):
    """Kernel H: g [M, H * dh] (dL/dout) and G's inputs -> (dz [N, H, dh],
    de_u [N, H], de_v [Nev, H])."""
    if g.device.type == "cpu":
        return gat_edge_bwd_ref(g, z, e_u, e_v, nbr_idx, src_valid, dst_idx)
    if g.device.type != "cuda":
        raise ValueError(f"gat_edge_bwd: unsupported device {g.device}")
    N, Nev, M, f, H, dh = _check(z, e_u, e_v, nbr_idx, src_valid, dst_idx)
    dev = z.device
    _build.check_tensor("g", g, torch.float32, (M, H * dh), dev)
    dz = torch.zeros((N, H, dh), dtype=torch.float32, device=dev)
    de_u = torch.zeros((N, H), dtype=torch.float32, device=dev)
    de_v = torch.zeros((Nev, H), dtype=torch.float32, device=dev)
    if M == 0 or f == 0 or H * dh == 0:
        return dz, de_u, de_v
    da = torch.empty((M, f, H), dtype=torch.float32, device=dev)
    lib = _build.load("gat_edge", _SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.gat_edge_bwd(g.data_ptr(), z.data_ptr(), e_u.data_ptr(),
                              e_v.data_ptr(), nbr_idx.data_ptr(),
                              src_valid.data_ptr(), _ptr(dst_idx),
                              da.data_ptr(), dz.data_ptr(), de_u.data_ptr(),
                              de_v.data_ptr(), N, Nev, M, f, H, dh, stream)
    if rc != 0:
        raise RuntimeError(f"gat_edge_bwd: launch failed with CUDA error {rc}")
    gat_edge_bwd.launches += 1
    return dz, de_u, de_v


gat_edge_bwd.launches = 0


class GatEdge(torch.autograd.Function):
    """GAT AGG with kernel G forward and kernel H backward."""

    @staticmethod
    def forward(ctx, z, e_u, e_v, nbr_idx, src_valid, dst_idx):
        ctx.save_for_backward(z, e_u, e_v, nbr_idx, src_valid, dst_idx)
        return gat_edge_fwd(z, e_u, e_v, nbr_idx, src_valid, dst_idx)

    @staticmethod
    def backward(ctx, g):
        if not any(ctx.needs_input_grad[:3]):
            return (None,) * 6
        z, e_u, e_v, nbr_idx, src_valid, dst_idx = ctx.saved_tensors
        dz, de_u, de_v = gat_edge_bwd(g.contiguous(), z, e_u, e_v, nbr_idx,
                                      src_valid, dst_idx)
        need = ctx.needs_input_grad
        return (dz if need[0] else None, de_u if need[1] else None,
                de_v if need[2] else None, None, None, None)


def gat_edge_aggregate(z: torch.Tensor, e_u: torch.Tensor, e_v: torch.Tensor,
                       nbr_idx: torch.Tensor, src_valid: torch.Tensor,
                       dst_idx: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Differentiable GAT AGG [M, H * dh] (kernels G and H on the card)."""
    return GatEdge.apply(z, e_u, e_v, nbr_idx, src_valid, dst_idx)
