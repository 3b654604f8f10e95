"""GraphSAGE (paper eq. 1) as an ``nn.Module`` — counterpart of
``repro/models/gnn/graphsage.py``:

    h^l_N(v) = mean({ f_u^{l-1} | u in N(v) })
    h^l_v    = Dropout(ReLU(W_n h^l_N(v) + W_s h^l_v + b))
               (no ReLU and no dropout on the last layer)

Two forwards, as the reference keeps its serving kernel apart from
``graphsage.forward``:

* :meth:`GraphSAGE.forward` serves (no gradient, no dropout): one call of
  the fused serve-layer kernel per layer (``kernels/serve_fused.py``),
  :meth:`GraphSAGE.serve_layer`, which the sharded scheduler calls layer
  by layer for every rank.
* :meth:`GraphSAGE.train_forward` trains: per layer the AGG kernel
  (``kernels/sage_agg.py``) and then the UPDATE kernel with the hash
  dropout (``kernels/update_fused.py``), both differentiable, layer ``k``
  drawing its mask from the u32 seed ``seed + k + 1``.

Every kernel wrapper runs its plain PyTorch version for CPU tensors.
:meth:`GraphSAGE.from_config` draws the reference's weights by default
(``init="reference"``: ``models/gnn/init.py``, bit for bit what
``init_params(jax.random.key(seed), ...)`` gives, as the reference's
launchers draw them); ``init="numpy"`` takes :func:`init_params_np`'s
weights from a numpy seed instead, at the same scales.  Weights keep the
reference's layout ``[D_in, D_out]``, so ``params_from_jax`` loads the
reference's ``{"layers": [{"wn", "ws", "b"}]}`` tree as it is;
``parameter_list`` orders them as that tree's leaves (per layer ``b``,
``wn``, ``ws``).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.sage_agg import sage_agg
from repro_torch.kernels.serve_fused import serve_fused_layer
from repro_torch.kernels.update_fused import fused_update
from repro_torch.models.gnn import init as init_lib

HaloHook = Callable[[int, torch.Tensor, torch.Tensor],
                    "tuple[torch.Tensor, torch.Tensor]"]


def layer_dims(feat_dim: int, hidden: int, num_classes: int,
               num_layers: int) -> List[int]:
    """feat -> hidden x (L-1) -> classes."""
    return [feat_dim] + [hidden] * (num_layers - 1) + [num_classes]


def init_params_np(seed: int, dims: Sequence[int]) -> dict:
    """He-normal weights (scale ``sqrt(2 / d_in)``) and zero biases from a
    numpy seed, in the reference's ``{"layers": [...]}`` tree: the scales
    of ``repro.models.gnn.graphsage.init_params``, other draws
    (``init="numpy"``; :func:`~repro_torch.models.gnn.init.graphsage_params`
    draws the reference's)."""
    rng = np.random.default_rng(seed)
    layers = []
    for din, dout in zip(dims[:-1], dims[1:]):
        s = np.float32((2.0 / din) ** 0.5)
        layers.append({
            "wn": rng.standard_normal((din, dout), np.float32) * s,
            "ws": rng.standard_normal((din, dout), np.float32) * s,
            "b": np.zeros(dout, np.float32)})
    return {"layers": layers}


def pick_init(init: str, reference, numpy):
    """The initializer ``init`` names: ``"reference"`` or ``"numpy"``."""
    inits = {"reference": reference, "numpy": numpy}
    if init not in inits:
        raise ValueError(f"unknown init {init!r}; expected one of "
                         f"{sorted(inits)}")
    return inits[init]


class SAGELayer(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.wn = nn.Parameter(torch.zeros(d_in, d_out))
        self.ws = nn.Parameter(torch.zeros(d_in, d_out))
        self.b = nn.Parameter(torch.zeros(d_out))

    def offline_chunk_fn(self, h: torch.Tensor, valid: torch.Tensor,
                         last: bool):
        """The layer over every vertex of the offline engine, one chunk of
        dst vertices at a time: ``fn(nbr [m, f], ids [m]) -> [m, d_out]``,
        one fused serve-layer launch with ``self_idx`` = ``ids``."""
        return lambda nbr, ids: serve_fused_layer(
            h, nbr, valid, self.wn, self.ws, self.b, relu=not last,
            self_idx=ids)


class GraphSAGE(nn.Module):
    def __init__(self, dims: Sequence[int]):
        super().__init__()
        self.dims = list(dims)
        self.layers = nn.ModuleList(
            SAGELayer(i, o) for i, o in zip(self.dims[:-1], self.dims[1:]))

    @classmethod
    def from_config(cls, cfg, seed: int = 0, device: DeviceLike = None,
                    params: Optional[dict] = None,
                    init: str = "reference") -> "GraphSAGE":
        """``cfg``'s GraphSAGE with the reference tree ``params``, or else
        random weights from ``seed`` (``init``: ``"reference"``, the
        reference's ``jax.random.key(seed)`` draws, or ``"numpy"``), on
        ``device`` (``None``: the card; raises without one)."""
        device = resolve_device(device)
        dims = layer_dims(cfg.feat_dim, cfg.hidden_size, cfg.num_classes,
                          cfg.num_layers)
        if params is None:
            params = pick_init(init, init_lib.graphsage_params,
                               init_params_np)(seed, dims)
        return cls(dims).params_from_jax(params).to(device)

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    def parameter_list(self) -> List[nn.Parameter]:
        """The parameters in the reference tree's leaf order."""
        return [getattr(layer, n) for layer in self.layers
                for n in ("b", "wn", "ws")]

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
    def serve_layer(self, k: int, h: torch.Tensor, nbr_idx: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
        """Serving layer ``k`` alone (one fused serve-layer launch): ``h
        [N_src, d_k]`` -> ``[N_dst, d_{k+1}]``, dst rows the prefix of the
        source rows; no ReLU on the last layer."""
        layer = self.layers[k]
        return serve_fused_layer(h, nbr_idx, valid, layer.wn, layer.ws,
                                 layer.b, relu=k < self.num_layers - 1)

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
        for k in range(L):
            nbr = blocks["nbr_idx"][k]
            last = k == L - 1
            h_new = self.serve_layer(k, h, nbr, valid)
            valid = valid[:nbr.shape[0]]
            if halo_hook is not None and not last:
                h_new, valid = halo_hook(k + 1, h_new, valid)
            h = h_new
        return h, valid

    def train_forward(self, h0: torch.Tensor, valid0: torch.Tensor,
                      blocks: dict, *, dropout: float, seed: int,
                      halo_hook: Optional[HaloHook] = None):
        """The training forward, differentiable in the parameters: per
        layer AGG then UPDATE (ReLU and ``dropout`` except on the last
        layer), with the halo hook after every layer but the last (k=0
        sees the input features).  ``seed`` is the step's u32 seed.
        Returns (h_final, valid), as :meth:`forward`."""
        h, valid = h0, valid0
        if halo_hook is not None:
            h, valid = halo_hook(0, h, valid)
        L = self.num_layers
        for k, layer in enumerate(self.layers):
            nbr = blocks["nbr_idx"][k]
            n_dst = nbr.shape[0]
            last = k == L - 1
            agg = sage_agg(h, nbr, valid)
            h_new = fused_update(agg, h[:n_dst], layer.wn, layer.ws, layer.b,
                                 relu=not last,
                                 dropout=0.0 if last else dropout,
                                 seed=(int(seed) + k + 1) & 0xFFFFFFFF)
            valid = valid[:n_dst]
            if halo_hook is not None and not last:
                h_new, valid = halo_hook(k + 1, h_new, valid)
            h = h_new
        return h, valid
