"""The fanout draw of one sampling layer as a CUDA kernel
(``csrc/sample_draw.cu``, kernel I).

Replaces the TPU kernel ``repro/kernels/sample_draw.py:sample_keys_kernel``
and the XLA around it in ``draw_neighbors_device``: the CSR expansion,
the selection keys (``uniform``, ``labor`` or ``cv``), the take-all rows
and the ``lax.top_k`` selection, in one launch that writes only the
``[n, f]`` draw.  :func:`draw_group` is the host's one choice for it: the
rows of a warp's tile, from ``n`` and the card's SM count.

:func:`sample_draw` launches the kernel for CUDA tensors and runs the
plain version ``draw_neighbors`` (re-exported here) for CPU tensors;
there is no fallback between the two.  ``sample_draw.launches`` counts
the kernel's launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (SAMPLE_POLICIES, draw_neighbors,
                                     sample_keys)
from repro_torch.utils import step_cost

__all__ = ["sample_draw", "draw_group", "draw_neighbors", "sample_keys"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "sample_draw": ([_P] * 6 + [_I] * 4 + [ctypes.c_uint32, _I, _I, _P], _I),
}
GROUPS = (1, 2, 4, 8, 16, 32)     # rows per tile the kernel takes
TILES_PER_SM = 96                 # the most tiles per SM draw_group plans


def draw_group(n: int, sms: int) -> int:
    """Rows of a warp's tile in kernel I for ``n`` frontier rows on
    ``sms`` SMs: the fewest at which the tiles number ``TILES_PER_SM`` a
    SM at most, up to 32 (a warp's lanes).  Smaller tiles spread the
    selection rows over more warps; but every tile is a warp to dispatch,
    and at one row a tile the 176,000 rows of training layer 0 took 3.4x
    as long as at 16 (PERF.md)."""
    for g in GROUPS:
        if -(-n // g) <= sms * TILES_PER_SM:
            return g
    return GROUPS[-1]


@step_cost.counted(step_cost.sample_draw_work)
def sample_draw(indptr: torch.Tensor, indices: torch.Tensor,
                wtab: torch.Tensor, cur: torch.Tensor, seed: int,
                allow: Optional[torch.Tensor], *, f: int, num_solid: int,
                width: int, policy: str = "uniform") -> torch.Tensor:
    """Kernel I: indptr [S+1] int32, indices [E] int32 (the solid CSR);
    wtab [S+H] float32 (read under ``cv`` only); cur [n] int32 frontier
    VID_p; a u32 ``seed``; allow [n] bool or None -> [n, f] int32.
    ``width`` (the CSR's largest degree) sizes the plain version's
    candidate matrix; the kernel needs none."""
    if policy not in SAMPLE_POLICIES:
        raise ValueError(f"unknown sample policy: {policy!r}")
    if cur.device.type == "cpu":
        return draw_neighbors(indptr, indices, wtab, cur, seed, allow, f=f,
                              num_solid=num_solid, width=width,
                              policy=policy)
    if cur.device.type != "cuda":
        raise ValueError(f"sample_draw: unsupported device {cur.device}")
    dev = cur.device
    n = cur.shape[0]
    if not 0 <= num_solid <= indptr.shape[0] - 1:
        raise ValueError(f"num_solid {num_solid} does not fit indptr of "
                         f"{indptr.shape[0]} entries")
    if not 0 <= int(seed) <= 0xFFFFFFFF:
        raise ValueError(f"seed {seed} is not a u32")
    _build.check_tensor("indptr", indptr, torch.int32, (indptr.shape[0],),
                        dev)
    _build.check_tensor("indices", indices, torch.int32,
                        (indices.shape[0],), dev)
    _build.check_tensor("wtab", wtab, torch.float32, (wtab.shape[0],), dev)
    _build.check_tensor("cur", cur, torch.int32, (n,), dev)
    if allow is not None:
        _build.check_tensor("allow", allow, torch.bool, (n,), dev)
    if wtab.shape[0] == 0:
        raise ValueError("wtab must hold at least one weight")
    out = torch.empty((n, max(f, 0)), dtype=torch.int32, device=dev)
    if n == 0 or f <= 0:
        return out
    lib = _build.load("sample_draw", _SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    group = draw_group(n, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    with torch.cuda.device(dev):
        rc = lib.sample_draw(indptr.data_ptr(), indices.data_ptr(),
                             wtab.data_ptr(), cur.data_ptr(),
                             None if allow is None else allow.data_ptr(),
                             out.data_ptr(), n, f, num_solid, wtab.shape[0],
                             int(seed), SAMPLE_POLICIES.index(policy),
                             group, stream)
    if rc != 0:
        raise RuntimeError(f"sample_draw: launch failed with CUDA error {rc}")
    sample_draw.launches += 1
    return out


sample_draw.launches = 0
