"""Input-shape registry (own copy of ``repro/configs/shapes.py``): the four
assigned (seq_len, global_batch) points.

``kind`` selects which step gets lowered in the dry-run:
  train   -> train_step     (forward + backward + optimizer update)
  prefill -> prefill_step   (build KV cache, last-token logits)
  decode  -> serve_step     (ONE new token against a seq_len-deep cache)
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

SHAPES: dict[str, InputShape] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


def get_shape(name: str) -> InputShape:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def shape_applicable(cfg, shape: InputShape) -> tuple[bool, str]:
    """(runs?, reason). long_500k needs sub-quadratic decode."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, (f"{cfg.name} is full-attention (no SWA/recurrent path); "
                       "long_500k skipped per DESIGN.md §Shape-applicability")
    return True, ""
