"""Device resolution for the port's entry points.

``device=None`` means the card (``"cuda"``).  There is no silent fallback:
without a CUDA device, ``None`` or ``"cuda"`` raises, and the CPU is used
only when the caller asks for it (``device="cpu"``, as the tests do).  On
the CPU every kernel wrapper runs its plain PyTorch version.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raises if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
