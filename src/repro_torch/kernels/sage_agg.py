"""GraphSAGE AGG, the masked mean of ``h_src`` rows at ``nbr_idx``, as
CUDA kernels (``csrc/sage_agg.cu``): the forward (kernel E) and its
gradient with respect to ``h_src`` (kernel F).

Replaces the TPU kernel ``repro/kernels/sage_agg.py:sage_agg``.
:func:`agg_form` is the host's one choice for E: the dst rows and the
column slice a warp owns, from the shape and the card's SM count.
:func:`sage_agg` is differentiable in ``h_src``: a
``torch.autograd.Function`` that keeps E's neighbor count for the
backward.  Autograd calls the backward only where ``h_src`` needs a
gradient, so layer 0 (the features) never launches F.

The wrappers launch the kernels for CUDA tensors and run the plain
versions ``sage_agg_ref``/``sage_agg_bwd_ref`` (re-exported here) for CPU
tensors; there is no fallback between the two.  ``.launches`` on each
wrapper counts its kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import sage_agg_bwd_ref, sage_agg_ref

__all__ = ["sage_agg", "sage_agg_fwd", "sage_agg_bwd", "agg_form",
           "sage_agg_ref", "sage_agg_bwd_ref"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "sage_agg_fwd": ([_P] * 5 + [_I] * 6 + [_P], _I),
    "sage_agg_bwd": ([_P] * 5 + [_I] * 4 + [_P], _I),
}
SLICE = 128                      # E's column slices are multiples of this
WAVE_WARPS_PER_SM = 32           # warps per SM of one wave, by design


def agg_form(M: int, f: int, D: int, sms: int):
    """``(rows, slice)`` of kernel E: the dst rows and the columns (a
    multiple of ``SLICE``) one warp owns.  Rows enough that their index
    lists fill one 32-slot chunk; where those warps would not make one
    wave of ``WAVE_WARPS_PER_SM`` a SM on ``sms`` SMs, fewer rows a warp,
    down to one, and then the columns split into more slices, down to
    ``SLICE`` wide."""
    rows = max(1, 32 // max(f, 1))
    slices, most = 1, max(1, -(-D // SLICE))
    while -(-M // rows) * slices < sms * WAVE_WARPS_PER_SM:
        if rows > 1:
            rows //= 2
        elif slices < most:
            slices += 1
        else:
            break
    return rows, max(1, -(-D // (slices * SLICE))) * SLICE


def _check(h_or_g, nbr_idx, src_valid, num_src, dev):
    if nbr_idx.dim() != 2 or h_or_g.dim() != 2:
        raise ValueError("nbr_idx and the row operand must be 2-D")
    M, f = nbr_idx.shape
    _build.check_tensor("nbr_idx", nbr_idx, torch.int32, (M, f), dev)
    _build.check_tensor("src_valid", src_valid, torch.bool, (num_src,), dev)


def sage_agg_fwd(h_src: torch.Tensor, nbr_idx: torch.Tensor,
                 src_valid: torch.Tensor):
    """Kernel E: h_src [N, D] f32; nbr_idx [M, f] int32 (-1 pad);
    src_valid [N] bool -> (mean [M, D], cnt [M] f32)."""
    if h_src.device.type == "cpu":
        return sage_agg_ref(h_src, nbr_idx, src_valid)
    if h_src.device.type != "cuda":
        raise ValueError(f"sage_agg_fwd: unsupported device {h_src.device}")
    dev = h_src.device
    _check(h_src, nbr_idx, src_valid, h_src.shape[0], dev)
    N, D = h_src.shape
    M, f = nbr_idx.shape
    _build.check_tensor("h_src", h_src, torch.float32, (N, D), dev)
    mean = torch.empty((M, D), dtype=torch.float32, device=dev)
    cnt = torch.empty(M, dtype=torch.float32, device=dev)
    if M == 0:
        return mean, cnt
    lib = _build.load("sage_agg", _SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows, slice_ = agg_form(M, f, D, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    with torch.cuda.device(dev):
        rc = lib.sage_agg_fwd(h_src.data_ptr(), nbr_idx.data_ptr(),
                              src_valid.data_ptr(), mean.data_ptr(),
                              cnt.data_ptr(), N, M, f, D, rows, slice_,
                              stream)
    if rc != 0:
        raise RuntimeError(f"sage_agg_fwd: launch failed with CUDA error {rc}")
    sage_agg_fwd.launches += 1
    return mean, cnt


sage_agg_fwd.launches = 0


def sage_agg_bwd(g: torch.Tensor, nbr_idx: torch.Tensor,
                 src_valid: torch.Tensor, cnt: torch.Tensor,
                 num_src: int) -> torch.Tensor:
    """Kernel F: g [M, D]; nbr_idx [M, f]; src_valid [num_src]; cnt [M]
    (E's count) -> dh [num_src, D]."""
    if g.device.type == "cpu":
        return sage_agg_bwd_ref(g, nbr_idx, src_valid, cnt, num_src)
    if g.device.type != "cuda":
        raise ValueError(f"sage_agg_bwd: unsupported device {g.device}")
    dev = g.device
    _check(g, nbr_idx, src_valid, num_src, dev)
    M, f = nbr_idx.shape
    D = g.shape[1]
    _build.check_tensor("g", g, torch.float32, (M, D), dev)
    _build.check_tensor("cnt", cnt, torch.float32, (M,), dev)
    dh = torch.zeros((num_src, D), dtype=torch.float32, device=dev)
    if M == 0 or D == 0:
        return dh
    lib = _build.load("sage_agg", _SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.sage_agg_bwd(g.data_ptr(), nbr_idx.data_ptr(),
                              src_valid.data_ptr(), cnt.data_ptr(),
                              dh.data_ptr(), num_src, M, f, D, stream)
    if rc != 0:
        raise RuntimeError(f"sage_agg_bwd: launch failed with CUDA error {rc}")
    sage_agg_bwd.launches += 1
    return dh


sage_agg_bwd.launches = 0


class SageAgg(torch.autograd.Function):
    """AGG with kernel E forward and kernel F backward."""

    @staticmethod
    def forward(ctx, h_src, nbr_idx, src_valid):
        mean, cnt = sage_agg_fwd(h_src, nbr_idx, src_valid)
        ctx.save_for_backward(nbr_idx, src_valid, cnt)
        ctx.num_src = h_src.shape[0]
        return mean

    @staticmethod
    def backward(ctx, g):
        nbr_idx, src_valid, cnt = ctx.saved_tensors
        dh = sage_agg_bwd(g.contiguous(), nbr_idx, src_valid, cnt,
                          ctx.num_src) if ctx.needs_input_grad[0] else None
        return dh, None, None


def sage_agg(h_src: torch.Tensor, nbr_idx: torch.Tensor,
             src_valid: torch.Tensor) -> torch.Tensor:
    """Differentiable masked mean [M, D] (kernels E and F on the card)."""
    return SageAgg.apply(h_src, nbr_idx, src_valid)
