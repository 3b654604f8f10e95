"""The reference's GNN initial weights without jax: the GraphSAGE and GAT
``init_params`` trees, drawn with ``jax.random.normal`` bit for bit
(:mod:`repro_torch.models.normal`).

The reference's launchers draw a model from ``jax.random.key(seed)``
(``repro/launch/train.py``, ``gnn_serve.py``, ``gnn_serve_dist.py``
through ``init_model_params``), and ``repro/models/gnn/graphsage.py`` and
``gat.py`` split that key per layer and draw ``jax.random.normal``.
``tests/test_torch_rng.py`` checks the trees against ``init_params`` at
the paper's widths.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.models.normal import F32, normal
from repro_torch.pipeline import threefry


def graphsage_params(seed: int, dims: Sequence[int]) -> dict:
    """``repro.models.gnn.graphsage.init_params(jax.random.key(seed),
    ...)`` at the widths ``dims``: per layer ``split(key, 3)`` gives
    ``wn``'s and ``ws``'s keys and the next key; He-normal scale
    ``sqrt(2 / d_in)``; zero ``b``."""
    key = threefry.key(seed)
    layers = []
    for din, dout in zip(dims[:-1], dims[1:]):
        k1, k2, key = threefry.split(key, 3)
        s = F32((2.0 / din) ** 0.5)
        layers.append({"wn": normal(k1, (din, dout)) * s,
                       "ws": normal(k2, (din, dout)) * s,
                       "b": np.zeros(dout, F32)})
    return {"layers": layers}


def gat_params(seed: int, shapes: Sequence[tuple]) -> dict:
    """``repro.models.gnn.gat.init_params(jax.random.key(seed), ...)`` at
    the per-layer ``(din, H, dh)`` of ``shapes``: per layer
    ``split(key, 4)`` gives ``w``'s, ``a_u``'s and ``a_v``'s keys and the
    next key; ``w`` scaled by ``sqrt(2 / din)``, ``a_u`` and ``a_v`` by
    ``dh ** -0.5``; zero ``b``."""
    key = threefry.key(seed)
    layers = []
    for din, H, dh in shapes:
        k1, k2, k3, key = threefry.split(key, 4)
        a = F32(dh ** -0.5)
        layers.append({"w": normal(k1, (din, H, dh)) * F32((2.0 / din) ** 0.5),
                       "b": np.zeros((H, dh), F32),
                       "a_u": normal(k2, (H, dh)) * a,
                       "a_v": normal(k3, (H, dh)) * a})
    return {"layers": layers}
