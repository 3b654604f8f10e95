"""GraphSAGE UPDATE, ``dropout(relu(agg@Wn + self@Ws + b))``, as CUDA
kernels (``csrc/update_fused.cu``): the forward (kernel C) and the
elementwise part of its gradient, ``dZ`` and ``db`` (kernel D).

Replaces the TPU kernel ``repro/kernels/update_fused.py:fused_update``.
Kernel C runs both products on the tensor cores, float32-accurate by the
3xTF32 split, in one of two block tiles (:func:`fwd_tile`).
:func:`fused_update` is differentiable: a ``torch.autograd.Function``
whose backward launches kernel D and leaves the four matrix products of
the gradient to ``torch.matmul``, computing only those its inputs need
(layer 0 needs no ``dagg``/``dself``: its inputs are the features).
Kernel D is one launch over :func:`bwd_stripes` row stripes, its column
sums finished by the last block in a fixed order.

The wrappers launch the kernels for CUDA tensors and run the plain
versions ``fused_update_ref``/``fused_update_bwd_ref`` (re-exported here)
for CPU tensors; there is no fallback between the two.  ``.launches``
on each wrapper counts its kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import fused_update_bwd_ref, fused_update_ref

__all__ = ["fused_update", "update_fused_fwd", "update_fused_bwd",
           "fused_update_ref", "fused_update_bwd_ref", "fwd_route",
           "fwd_tile", "bwd_stripes"]

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_uint32
_SIGNATURES = {
    "update_fused_fwd": ([_P] * 6 + [_I] * 4 + [_F, _F, _U, _I, _P], _I),
    "update_fused_bwd": ([_P] * 6 + [_I] * 3 + [_F, _F, _U, _I, _P], _I),
}
_U32 = 0xFFFFFFFF
TILES = {1: (128, 64), 0: (32, 64)}  # kernel C's block tiles (rows, columns)


def fwd_tile(N: int, K: int, sms: int) -> int:
    """Kernel C's block tile for an ``[N, K]`` output on a card of ``sms``
    SMs: 128 x 64 (key 1) when that grid fills every SM, else 32 x 64
    (key 0), four times the blocks."""
    big = TILES[1]
    blocks = -(-N // big[0]) * -(-K // big[1])
    return 1 if blocks >= sms else 0


BWD_ROWS_MIN = 32                # fewest rows in one of kernel D's stripes
BWD_BLOCKS_PER_SM = 2            # kernel D's stripes per SM at large N


def bwd_stripes(N: int, sms: int) -> int:
    """Kernel D's row stripes (one block each) for ``N`` rows on a card
    of ``sms`` SMs: two per SM, all resident at once, unless that leaves
    a stripe under 32 rows."""
    return max(1, min(N // BWD_ROWS_MIN, BWD_BLOCKS_PER_SM * sms))


# kernel D's ticket, one zeroed counter per (device, stream): each launch
# leaves it 0 again, and launches on one stream never overlap
_tickets = {}


def _ticket(dev: torch.device, stream: int) -> torch.Tensor:
    key = (dev.index, stream)
    t = _tickets.get(key)
    if t is None:
        t = _tickets[key] = torch.zeros(1, dtype=torch.int32, device=dev)
    return t


def fwd_route(N: int, K: int, sms: int) -> str:
    """The route kernel C takes at ``[N, K]``: the 3xTF32 tensor-core
    products and the block tile."""
    rows, cols = TILES[fwd_tile(N, K, sms)]
    return f"3xTF32 mma.sync {rows}x{cols}"


def _dropout_args(dropout: float, seed: int):
    """(p, 1 - p) as the float32 values the reference compares and
    divides by, and the u32 seed."""
    if not 0.0 <= dropout < 1.0:
        raise ValueError(f"dropout must be in [0, 1), got {dropout}")
    return float(dropout), float(1.0 - dropout), int(seed) & _U32


def update_fused_fwd(agg: torch.Tensor, self_h: torch.Tensor,
                     wn: torch.Tensor, ws: torch.Tensor, b: torch.Tensor, *,
                     relu: bool = True, dropout: float = 0.0,
                     seed: int = 0) -> torch.Tensor:
    """Kernel C: agg, self_h [N, C]; wn, ws [C, K]; b [K] -> [N, K]."""
    if agg.device.type == "cpu":
        return fused_update_ref(agg, self_h, wn, ws, b, relu=relu,
                                dropout=dropout, seed=seed)
    if agg.device.type != "cuda":
        raise ValueError(f"update_fused_fwd: unsupported device {agg.device}")
    dev = agg.device
    if agg.dim() != 2 or wn.dim() != 2:
        raise ValueError("agg and wn must be 2-D")
    N, C = agg.shape
    K = wn.shape[1]
    for name, t, shape in (("agg", agg, (N, C)), ("self_h", self_h, (N, C)),
                           ("wn", wn, (C, K)), ("ws", ws, (C, K)),
                           ("b", b, (K,))):
        _build.check_tensor(name, t, torch.float32, shape, dev)
    p, keep_div, seed = _dropout_args(dropout, seed)
    out = torch.empty((N, K), dtype=torch.float32, device=dev)
    if N == 0 or K == 0:
        return out
    lib = _build.load("update_fused", _SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tile = fwd_tile(N, K, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    with torch.cuda.device(dev):
        rc = lib.update_fused_fwd(
            agg.data_ptr(), self_h.data_ptr(), wn.data_ptr(), ws.data_ptr(),
            b.data_ptr(), out.data_ptr(), N, C, K, int(relu), p, keep_div,
            seed, tile, stream)
    if rc != 0:
        raise RuntimeError(f"update_fused_fwd: launch failed with CUDA "
                           f"error {rc}")
    update_fused_fwd.launches += 1
    return out


update_fused_fwd.launches = 0


def update_fused_bwd(g: torch.Tensor, out: torch.Tensor, *, relu: bool = True,
                     dropout: float = 0.0, seed: int = 0):
    """Kernel D: output gradient g [N, K] and forward output out [N, K]
    -> (dZ [N, K], db [K])."""
    if g.device.type == "cpu":
        return fused_update_bwd_ref(g, out, relu=relu, dropout=dropout,
                                    seed=seed)
    if g.device.type != "cuda":
        raise ValueError(f"update_fused_bwd: unsupported device {g.device}")
    dev = g.device
    if g.dim() != 2:
        raise ValueError("g must be 2-D")
    N, K = g.shape
    _build.check_tensor("g", g, torch.float32, (N, K), dev)
    _build.check_tensor("out", out, torch.float32, (N, K), dev)
    p, keep_div, seed = _dropout_args(dropout, seed)
    dz = torch.empty((N, K), dtype=torch.float32, device=dev)
    if N == 0 or K == 0:
        return dz, torch.zeros(K, dtype=torch.float32, device=dev)
    db = torch.empty(K, dtype=torch.float32, device=dev)
    stripes = bwd_stripes(N, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    partial = torch.empty((stripes, K), dtype=torch.float32, device=dev)
    lib = _build.load("update_fused", _SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.update_fused_bwd(
            g.data_ptr(), out.data_ptr(), dz.data_ptr(), db.data_ptr(),
            partial.data_ptr(), _ticket(dev, stream).data_ptr(), N, K,
            int(relu), p, keep_div, seed, stripes, stream)
    if rc != 0:
        raise RuntimeError(f"update_fused_bwd: launch failed with CUDA "
                           f"error {rc}")
    update_fused_bwd.launches += 1
    return dz, db


update_fused_bwd.launches = 0


class FusedUpdate(torch.autograd.Function):
    """UPDATE with kernel C forward and kernel D + matmuls backward."""

    @staticmethod
    def forward(ctx, agg, self_h, wn, ws, b, relu, dropout, seed):
        out = update_fused_fwd(agg, self_h, wn, ws, b, relu=relu,
                               dropout=dropout, seed=seed)
        ctx.save_for_backward(agg, self_h, wn, ws, out)
        ctx.cfg = (relu, dropout, seed)
        return out

    @staticmethod
    def backward(ctx, g):
        agg, self_h, wn, ws, out = ctx.saved_tensors
        relu, dropout, seed = ctx.cfg
        dz, db = update_fused_bwd(g.contiguous(), out, relu=relu,
                                  dropout=dropout, seed=seed)
        need = ctx.needs_input_grad
        return (dz @ wn.T if need[0] else None,
                dz @ ws.T if need[1] else None,
                agg.T @ dz if need[2] else None,
                self_h.T @ dz if need[3] else None,
                db if need[4] else None, None, None, None)


def fused_update(agg: torch.Tensor, self_h: torch.Tensor, wn: torch.Tensor,
                 ws: torch.Tensor, b: torch.Tensor, *, relu: bool = True,
                 dropout: float = 0.0, seed: int = 0) -> torch.Tensor:
    """Differentiable UPDATE (kernels C and D on the card)."""
    return FusedUpdate.apply(agg, self_h, wn, ws, b, relu, float(dropout),
                             int(seed) & _U32)
