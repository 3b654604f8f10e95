"""GAT (paper eq. 2, with the paper's modification: bias and ReLU applied
to the projection before the attention coefficients) as an
``nn.Module`` — counterpart of ``repro/models/gnn/gat.py``:

    z_u      = ReLU(W f_u + b)                       per head, [H, dh]
    e_u      = a_u . z_u ;  e_v = a_v . z_v
    alpha_uv = EdgeSoftmax(LeakyReLU(e_u + e_v))
    h_v      = sum_u alpha_uv z_u                    (no ReLU after it)

Hidden layers have ``num_heads`` heads of ``hidden`` each (their output
is ``hidden * num_heads`` wide); the last layer has one head of
``num_classes``.  Per layer the projection is ``torch.addmm`` and the two
logits are one product of ``z`` with a block-diagonal ``[H*dh, 2H]``
matrix (the reference's ``(z * a_u).sum(-1)``, without a second tensor of
``z``'s size); the edge softmax and the weighted sum are the GAT AGG
kernel (``kernels/gat_edge.py``), differentiable in ``z``, ``e_u`` and
``e_v``.  :meth:`GAT.train_forward` applies the hash dropout after every
layer but the last, layer ``k`` drawing its mask from the u32 seed
``seed + k + 1``; :meth:`GAT.forward` serves (no gradient, no dropout).

:meth:`GAT.from_config` draws the reference's weights by default
(``init="reference"``: ``models/gnn/init.py``, bit for bit
``init_params(jax.random.key(seed), ...)``); ``init="numpy"`` takes
:func:`init_params_np`'s.  Parameters keep the reference's layout
(``w [din, H, dh]``, ``b``, ``a_u``, ``a_v`` ``[H, dh]``), so
``params_from_jax`` loads its
``{"layers": [{"w", "b", "a_u", "a_v"}]}`` tree as it is;
``parameter_list`` orders them as that tree's leaves (per layer ``a_u``,
``a_v``, ``b``, ``w``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.gat_edge import gat_edge_aggregate
from repro_torch.models.gnn.common import hash_dropout
from repro_torch.models.gnn import init as init_lib
from repro_torch.models.gnn.graphsage import HaloHook, pick_init

LEAVES = ("a_u", "a_v", "b", "w")     # the reference tree's sorted keys

Shape = Tuple[int, int, int]          # (din, heads, dh)


def layer_shapes(feat_dim: int, hidden: int, num_classes: int,
                 num_layers: int, num_heads: int) -> List[Shape]:
    """(din, H, dh) per layer: feat -> hidden x heads (L-1) -> classes x 1."""
    dins = [feat_dim] + [hidden * num_heads] * (num_layers - 1)
    douts = [hidden] * (num_layers - 1) + [num_classes]
    heads = [num_heads] * (num_layers - 1) + [1]
    return list(zip(dins, heads, douts))


def init_params_np(seed: int, shapes: Sequence[Shape]) -> dict:
    """Weights from a numpy seed at the reference's scales (``w`` normal x
    ``sqrt(2 / din)``, ``a_u``/``a_v`` normal x ``dh ** -0.5``, zero
    ``b``), in its ``{"layers": [...]}`` tree, other draws than its
    (``init="numpy"``)."""
    rng = np.random.default_rng(seed)
    layers = []
    for din, H, dh in shapes:
        s = np.float32((2.0 / din) ** 0.5)
        a = np.float32(dh ** -0.5)
        layers.append({
            "w": rng.standard_normal((din, H, dh), np.float32) * s,
            "b": np.zeros((H, dh), np.float32),
            "a_u": rng.standard_normal((H, dh), np.float32) * a,
            "a_v": rng.standard_normal((H, dh), np.float32) * a})
    return {"layers": layers}


class GATLayer(nn.Module):
    def __init__(self, din: int, heads: int, dh: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(din, heads, dh))
        self.b = nn.Parameter(torch.zeros(heads, dh))
        self.a_u = nn.Parameter(torch.zeros(heads, dh))
        self.a_v = nn.Parameter(torch.zeros(heads, dh))

    def project(self, h: torch.Tensor):
        """h [N, din] -> (z [N, H, dh], e_u [N, H], e_v [N, H])."""
        din, H, dh = self.w.shape
        z = torch.relu_(torch.addmm(self.b.reshape(-1), h,
                                    self.w.reshape(din, H * dh)))
        # [H*dh, 2H]: column h holds a_u[h] in rows h*dh..(h+1)*dh, column
        # H + h holds a_v[h]
        eye = torch.eye(H, dtype=z.dtype, device=z.device)[:, None, :]
        att = torch.cat([(eye * self.a_u[:, :, None]).reshape(H * dh, H),
                         (eye * self.a_v[:, :, None]).reshape(H * dh, H)], 1)
        e = z @ att
        return z.view(-1, H, dh), e[:, :H].contiguous(), e[:, H:].contiguous()

    def forward(self, h: torch.Tensor, nbr_idx: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
        """h [N_src, din] -> [N_dst, H * dh] (before the dropout); dst rows
        are the prefix of the source rows."""
        return gat_edge_aggregate(*self.project(h), nbr_idx, valid)

    def offline_chunk_fn(self, h: torch.Tensor, valid: torch.Tensor,
                         last: bool):
        """The layer over every vertex of the offline engine, one chunk of
        dst vertices at a time: ``z``, ``e_u`` and ``e_v`` projected once
        for all vertices (the reference's ``_gat_nodes``), then ``fn(nbr
        [m, f], ids [m]) -> [m, H * dh]``, one GAT AGG launch with
        ``dst_idx`` = ``ids`` (its ``_gat_chunk``).  ``last`` changes
        nothing: no layer applies a ReLU after the aggregation."""
        z, e_u, e_v = self.project(h)
        return lambda nbr, ids: gat_edge_aggregate(z, e_u, e_v, nbr, valid,
                                                   ids)


class GAT(nn.Module):
    def __init__(self, shapes: Sequence[Shape]):
        super().__init__()
        self.shapes = [tuple(s) for s in shapes]
        self.layers = nn.ModuleList(GATLayer(*s) for s in self.shapes)

    @classmethod
    def from_config(cls, cfg, seed: int = 0, device: DeviceLike = None,
                    params: Optional[dict] = None,
                    init: str = "reference") -> "GAT":
        """``cfg``'s GAT with the reference tree ``params``, or else random
        weights from ``seed`` (``init``: ``"reference"``, the reference's
        ``jax.random.key(seed)`` draws, or ``"numpy"``), on ``device``
        (``None``: the card; raises without one)."""
        device = resolve_device(device)
        shapes = layer_shapes(cfg.feat_dim, cfg.hidden_size, cfg.num_classes,
                              cfg.num_layers, cfg.num_heads)
        if params is None:
            params = pick_init(init, init_lib.gat_params,
                               init_params_np)(seed, shapes)
        return cls(shapes).params_from_jax(params).to(device)

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    def parameter_list(self) -> List[nn.Parameter]:
        """The parameters in the reference tree's leaf order."""
        return [getattr(layer, n) for layer in self.layers for n in LEAVES]

    @torch.no_grad()
    def params_from_jax(self, params_np: dict) -> "GAT":
        """Load the reference's ``{"layers": [{"w","b","a_u","a_v"}]}``
        tree (numpy arrays) into this module."""
        if len(params_np["layers"]) != self.num_layers:
            raise ValueError(f"{len(params_np['layers'])} layers given, "
                             f"model has {self.num_layers}")
        for layer, p in zip(self.layers, params_np["layers"]):
            for name in LEAVES:
                dst = getattr(layer, name)
                src = torch.as_tensor(np.asarray(p[name], np.float32))
                if src.shape != dst.shape:
                    raise ValueError(f"{name}: shape {tuple(src.shape)}, "
                                     f"expected {tuple(dst.shape)}")
                dst.copy_(src)
        return self

    def _run(self, h0, valid0, blocks, dropout: float, seed: int,
             halo_hook: Optional[HaloHook]):
        h, valid = h0, valid0
        if halo_hook is not None:
            h, valid = halo_hook(0, h, valid)
        L = self.num_layers
        for k, layer in enumerate(self.layers):
            nbr = blocks["nbr_idx"][k]
            last = k == L - 1
            h_new = layer(h, nbr, valid)
            if not last and dropout > 0:
                h_new = hash_dropout(h_new, dropout,
                                     (int(seed) + k + 1) & 0xFFFFFFFF)
            valid = valid[:nbr.shape[0]]
            if halo_hook is not None and not last:
                h_new, valid = halo_hook(k + 1, h_new, valid)
            h = h_new
        return h, valid

    @torch.no_grad()
    def serve_layer(self, k: int, h: torch.Tensor, nbr_idx: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
        """Serving layer ``k`` alone (projection, then one GAT AGG
        launch): ``h [N_src, d_k]`` -> ``[N_dst, H * dh]``, dst rows the
        prefix of the source rows; what :meth:`forward` computes per
        layer."""
        return self.layers[k](h, nbr_idx, valid)

    @torch.no_grad()
    def forward(self, h0: torch.Tensor, valid0: torch.Tensor,
                blocks: dict, halo_hook: Optional[HaloHook] = None):
        """Serving forward (no gradient, no dropout), with the contract of
        ``GraphSAGE.forward``: ``blocks["nbr_idx"]`` one int32 tensor per
        layer, ``halo_hook(k, h, valid)`` after every layer but the last
        (k=0 sees the input).  Returns (h_final, valid)."""
        return self._run(h0, valid0, blocks, 0.0, 0, halo_hook)

    def train_forward(self, h0: torch.Tensor, valid0: torch.Tensor,
                      blocks: dict, *, dropout: float, seed: int,
                      halo_hook: Optional[HaloHook] = None):
        """The training forward, differentiable in the parameters, with the
        hash ``dropout`` after every layer but the last (``seed`` is the
        step's u32 seed).  Returns (h_final, valid)."""
        return self._run(h0, valid0, blocks, dropout, seed, halo_hook)
