"""Fused HEC probe + load (HECSearch + HECLoad) in CUDA kernels
(``csrc/hec_search.cu``).

* :func:`hec_lookup` (kernel B) replaces the TPU kernel
  ``repro/kernels/hec_search.py:hec_search_kernel`` together with the
  HECLoad gather that ``repro/cache/hec.py:hec_lookup`` composes around
  it: per vid, the Fibonacci set hash, a compare against that set's tag
  row, and the copy of the hit line (zeros on a miss).
* :func:`hec_probe` (kernel J) replaces ``hec_search_batched`` with the
  gather of ``hec_probe`` around it, for the responder side of the
  serve-side cache fetch: R stacked caches probed with ``[R, B, n]`` vids
  in one launch, each row written with its ok flag (the hit, masked by
  the responder's ``alive`` entry) into the ``[R, B, n, d + 1]`` response
  buffer.

Both are bit-exact to their plain versions ``hec_lookup_ref`` and
``hec_probe_ref`` (re-exported here), which the wrappers run for CPU
tensors.  ``hec_lookup.launches`` and ``hec_probe.launches`` count kernel
launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import hec_lookup_ref, hec_probe_ref, set_index

__all__ = ["hec_lookup", "hec_lookup_ref", "hec_probe", "hec_probe_ref",
           "set_index"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"hec_lookup": ([_P] * 7 + [_I] * 4 + [_P], _I),
               "hec_probe": ([_P] * 5 + [_L] * 2 + [_I] * 3 + [_P], _I)}
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


def hec_probe(tags: torch.Tensor, values: torch.Tensor, vids: torch.Tensor,
              alive: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tags [R, nsets, ways] int32; values [R, nsets, ways, d] f32; vids
    [R, B, n] int32; alive [R] bool or None (every rank alive) ->
    [R, B, n, d + 1] f32: per probe the value row (zeros on a miss) and
    the ok flag, 1.0 or 0.0, in column d."""
    if tags.device.type == "cpu":
        return hec_probe_ref(tags, values, vids, alive)
    if tags.device.type != "cuda":
        raise ValueError(f"hec_probe: unsupported device {tags.device}")
    dev = tags.device
    if tags.dim() != 3 or values.dim() != 4 or vids.dim() != 3:
        raise ValueError("tags, values and vids must be 3-, 4- and 3-D")
    R, nsets, ways = tags.shape
    d = values.shape[3]
    B, n = vids.shape[1:]
    _build.check_tensor("tags", tags, torch.int32, (R, nsets, ways), dev)
    _build.check_tensor("values", values, torch.float32, (R, nsets, ways, d),
                        dev)
    _build.check_tensor("vids", vids, torch.int32, (R, B, n), dev)
    if alive is not None:
        _build.check_tensor("alive", alive, torch.bool, (R,), dev)
    if not 0 < ways <= MAX_WAYS or nsets == 0:
        raise ValueError(f"need 1 <= ways <= {MAX_WAYS} and nsets > 0, got "
                         f"ways={ways}, nsets={nsets}")
    out = torch.empty((R, B, n, d + 1), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = _build.load("hec_search", _SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.hec_probe(tags.data_ptr(), values.data_ptr(),
                           vids.data_ptr(),
                           None if alive is None else alive.data_ptr(),
                           out.data_ptr(), R, B * n, nsets, ways, d, stream)
    if rc != 0:
        raise RuntimeError(f"hec_probe: launch failed with CUDA error {rc}")
    hec_probe.launches += 1
    return out


hec_probe.launches = 0
