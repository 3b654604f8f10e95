"""Fused HEC probe + load (HECSearch + HECLoad) in one CUDA kernel
(``csrc/hec_search.cu``).

Replaces the TPU kernel ``repro/kernels/hec_search.py:hec_search_kernel``
together with the HECLoad gather that ``repro/cache/hec.py:hec_lookup``
composes around it: per vid, the Fibonacci set hash, a compare against
that set's tag row, and the copy of the hit line (zeros on a miss).  All
four outputs are bit-exact to the plain version ``hec_lookup_ref``
(re-exported here), which the wrapper runs for CPU tensors.
``hec_lookup.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import hec_lookup_ref, set_index

__all__ = ["hec_lookup", "hec_lookup_ref", "set_index"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"hec_lookup": ([_P] * 7 + [_I] * 4 + [_P], _I)}
MAX_WAYS = 32                    # one lane per way


def hec_lookup(tags: torch.Tensor, values: torch.Tensor,
               vids: torch.Tensor):
    """tags [nsets, ways] int32; values [nsets, ways, d] f32; vids [n] int32
    -> (hit [n] bool, set [n] int32, way [n] int32, emb [n, d] f32)."""
    if tags.device.type == "cpu":
        return hec_lookup_ref(tags, values, vids)
    if tags.device.type != "cuda":
        raise ValueError(f"hec_lookup: unsupported device {tags.device}")
    dev = tags.device
    if tags.dim() != 2 or values.dim() != 3 or vids.dim() != 1:
        raise ValueError("tags, values and vids must be 2-, 3- and 1-D")
    nsets, ways = tags.shape
    d = values.shape[2]
    n = vids.shape[0]
    _build.check_tensor("tags", tags, torch.int32, (nsets, ways), dev)
    _build.check_tensor("values", values, torch.float32, (nsets, ways, d), dev)
    _build.check_tensor("vids", vids, torch.int32, (n,), dev)
    if not 0 < ways <= MAX_WAYS or nsets == 0:
        raise ValueError(f"need 1 <= ways <= {MAX_WAYS} and nsets > 0, got "
                         f"ways={ways}, nsets={nsets}")
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    sets = torch.empty(n, dtype=torch.int32, device=dev)
    way = torch.empty(n, dtype=torch.int32, device=dev)
    emb = torch.empty((n, d), dtype=torch.float32, device=dev)
    if n == 0:
        return hit, sets, way, emb
    lib = _build.load("hec_search", _SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.hec_lookup(tags.data_ptr(), values.data_ptr(),
                            vids.data_ptr(), hit.data_ptr(), sets.data_ptr(),
                            way.data_ptr(), emb.data_ptr(), n, nsets, ways, d,
                            stream)
    if rc != 0:
        raise RuntimeError(f"hec_lookup: launch failed with CUDA error {rc}")
    hec_lookup.launches += 1
    return hit, sets, way, emb


hec_lookup.launches = 0
