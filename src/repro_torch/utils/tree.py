"""Small parameter-tree helpers (own copy of ``repro/utils/tree.py``):
counts, bytes and finiteness over the port's nested dicts of tensors, in
the reference's leaf order (``models/transformer/model.py:tree_leaves``,
which is ``jax.tree_util.tree_leaves``'s)."""
from __future__ import annotations

import torch


def _leaves(tree) -> list:
    from repro_torch.models.transformer.model import tree_leaves
    return tree_leaves(tree)


def tree_count_params(tree) -> int:
    return sum(x.numel() for x in _leaves(tree))


def tree_size_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in _leaves(tree))


def tree_finite(tree) -> bool:
    return all(bool(torch.isfinite(x).all()) for x in _leaves(tree)
               if x.is_floating_point())
