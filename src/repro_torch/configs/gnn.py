"""GNN model configs (own copy of ``repro/configs/gnn.py``'s model part).

Serving reads the model shape only: layer count, widths, fanouts.  The
training hyperparameters ``lr`` and ``dropout`` are kept as inert fields
so the presets read the same as the reference; the HEC/AEP and pipeline
knobs wait for the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    model: str                       # "graphsage" | "gat"
    fanouts: Sequence[int] = (5, 10, 15)   # sampled neighbors per layer (L2..L0)
    hidden_size: int = 256
    num_hidden_layers: int = 2       # => 3 GNN layers total (paper: 3-layer models)
    num_heads: int = 4               # GAT only
    batch_size: int = 1000
    lr: float = 0.003                # training only (inert here)
    dropout: float = 0.5             # training only (serving runs without)
    aggregator: str = "mean"         # graphsage: mean; gat: gcn
    feat_dim: int = 128
    num_classes: int = 172

    @property
    def num_layers(self) -> int:
        return self.num_hidden_layers + 1


# Paper-faithful preset (Table 2): GraphSAGE on ogbn-papers100M.
GRAPHSAGE_PAPERS100M = GNNConfig(
    name="graphsage-papers100m", model="graphsage", lr=0.006,
    feat_dim=128, num_classes=172)


def small_gnn_config(model: str = "graphsage", **over) -> GNNConfig:
    """CPU-sized preset for tests/examples on synthetic graphs."""
    defaults = dict(
        name=f"{model}-small", model=model, fanouts=(5, 5), hidden_size=64,
        num_hidden_layers=1, batch_size=64, feat_dim=32, num_classes=8,
        lr=0.01, dropout=0.1)
    if model == "gat":
        defaults["aggregator"] = "gcn"
    defaults.update(over)
    return GNNConfig(**defaults)
