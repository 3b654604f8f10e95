"""GraphSAGE (paper eq. 1) as an ``nn.Module`` — counterpart of
``repro/models/gnn/graphsage.py`` for inference:

    h^l_N(v) = mean({ f_u^{l-1} | u in N(v) })
    h^l_v    = ReLU(W_n h^l_N(v) + W_s h^l_v + b)      (no ReLU on the last)

Each layer is one call of the fused serve-layer kernel
(``kernels/serve_fused.py``), which runs its plain PyTorch version for
CPU tensors.  Weights keep the reference's layout ``[D_in, D_out]``, so
``params_from_jax`` loads the reference's ``{"layers": [{"wn", "ws",
"b"}]}`` tree as it is.  The module is inference-only: dropout and the
backward kernels come with the training slice.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.kernels.serve_fused import serve_fused_layer

HaloHook = Callable[[int, torch.Tensor, torch.Tensor],
                    "tuple[torch.Tensor, torch.Tensor]"]


def layer_dims(feat_dim: int, hidden: int, num_classes: int,
               num_layers: int) -> List[int]:
    """feat -> hidden x (L-1) -> classes."""
    return [feat_dim] + [hidden] * (num_layers - 1) + [num_classes]


def init_params_np(seed: int, dims: Sequence[int]) -> dict:
    """He-normal weights (scale ``sqrt(2 / d_in)``) and zero biases from a
    numpy seed, in the reference's ``{"layers": [...]}`` tree: the same
    scale as ``repro.models.gnn.graphsage.init_params``, whose
    ``jax.random`` bits torch cannot reproduce."""
    rng = np.random.default_rng(seed)
    layers = []
    for din, dout in zip(dims[:-1], dims[1:]):
        s = np.float32((2.0 / din) ** 0.5)
        layers.append({
            "wn": rng.standard_normal((din, dout), np.float32) * s,
            "ws": rng.standard_normal((din, dout), np.float32) * s,
            "b": np.zeros(dout, np.float32)})
    return {"layers": layers}


class SAGELayer(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.wn = nn.Parameter(torch.zeros(d_in, d_out), requires_grad=False)
        self.ws = nn.Parameter(torch.zeros(d_in, d_out), requires_grad=False)
        self.b = nn.Parameter(torch.zeros(d_out), requires_grad=False)


class GraphSAGE(nn.Module):
    def __init__(self, dims: Sequence[int]):
        super().__init__()
        self.dims = list(dims)
        self.layers = nn.ModuleList(
            SAGELayer(i, o) for i, o in zip(self.dims[:-1], self.dims[1:]))

    @classmethod
    def from_config(cls, cfg, seed: int = 0,
                    device: torch.device = torch.device("cpu")) -> "GraphSAGE":
        """Random He-normal model of ``cfg``'s widths from a numpy seed."""
        dims = layer_dims(cfg.feat_dim, cfg.hidden_size, cfg.num_classes,
                          cfg.num_layers)
        model = cls(dims)
        model.params_from_jax(init_params_np(seed, dims))
        return model.to(device)

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    @torch.no_grad()
    def params_from_jax(self, params_np: dict) -> "GraphSAGE":
        """Load the reference's ``{"layers": [{"wn","ws","b"}]}`` tree
        (numpy arrays, ``[D_in, D_out]`` weights) into this module."""
        if len(params_np["layers"]) != self.num_layers:
            raise ValueError(f"{len(params_np['layers'])} layers given, "
                             f"model has {self.num_layers}")
        for layer, p in zip(self.layers, params_np["layers"]):
            for name in ("wn", "ws", "b"):
                dst = getattr(layer, name)
                src = torch.as_tensor(np.asarray(p[name], np.float32))
                if src.shape != dst.shape:
                    raise ValueError(f"{name}: shape {tuple(src.shape)}, "
                                     f"expected {tuple(dst.shape)}")
                dst.copy_(src)
        return self

    @torch.no_grad()
    def forward(self, h0: torch.Tensor, valid0: torch.Tensor,
                blocks: dict, halo_hook: Optional[HaloHook] = None):
        """h0 [N_0, F] input-layer features; valid0 [N_0] bool.

        blocks: dict with the ``nbr_idx`` list (int32 tensors, one per
        layer).  ``halo_hook(k, h, valid) -> (h, valid)`` substitutes cached
        embeddings after layer k is computed (k=0 sees the input features)
        — the reference's hook contract.  Returns (h_final, valid)."""
        h, valid = h0, valid0
        if halo_hook is not None:
            h, valid = halo_hook(0, h, valid)
        L = self.num_layers
        for k, layer in enumerate(self.layers):
            nbr = blocks["nbr_idx"][k]
            last = k == L - 1
            h_new = serve_fused_layer(h, nbr, valid, layer.wn, layer.ws,
                                      layer.b, relu=not last)
            valid = valid[:nbr.shape[0]]
            if halo_hook is not None and not last:
                h_new, valid = halo_hook(k + 1, h_new, valid)
            h = h_new
        return h, valid
