"""GNN configs (own copy of ``repro/configs/gnn.py``): the paper's models
and its HEC/AEP hyperparameters (Table 2 and §4.4: cs=1M entries per
layer, nc=2000, ls=2, d=1, minibatch 1000, fan-out 5,10,15).

Serving reads the model shape; training reads ``lr``, ``dropout``, the
HEC/AEP knobs with the replicated hot tier (``hec``) and the minibatch
prefetch and fanout draw (``pipeline``).  The reference's double-buffered
staging waits for its slice.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class HECConfig:
    """Historical Embedding Cache and push parameters (paper §3.2/§4.4),
    and the replicated hot-vertex tier of ``aep`` training.

    ``hot_size > 0`` replicates the top-K highest-degree halo'd vertices
    on every rank: they leave the pairwise push contract, and each rank
    broadcasts up to ``hot_budget`` of the hot vertices it owns per step
    as one more segment of the same fused push.  Replicas age with the
    HEC life-span, so ``hot_budget * life_span`` should cover the hot
    vertices of the busiest owner (the trainer warns when it does not).
    Both 0 (default) leaves the tier off."""
    cache_size: int = 1_000_000     # cs: entries per layer
    ways: int = 8                   # set-associativity
    life_span: int = 2              # ls: purge lines older than this
    push_limit: int = 2000          # nc: max solid embeddings pushed per rank pair
    delay: int = 1                  # d: iterations between push and consume
    hot_size: int = 0               # K: replicated hot-tier slots (0 = off)
    hot_budget: int = 0             # hot rows broadcast per rank per step

    def __post_init__(self):
        if self.cache_size % self.ways:
            raise ValueError("cache_size must be a multiple of ways")
        if (self.hot_size > 0) != (self.hot_budget > 0):
            raise ValueError("hot_size and hot_budget must be enabled "
                             "together")

    @property
    def num_sets(self) -> int:
        return self.cache_size // self.ways


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Fanout-draw policy and placement (host numpy or the card).

    ``device_draw=False`` (default) keeps the host vectorized sampler.
    ``device_draw=True`` runs each layer's neighbor draw through kernel I
    (``kernels/sample_draw.py``; its plain version on the CPU), seeded per
    (base_seed, epoch, step, rank, layer) by the reference's ``fold_in``
    chain (``pipeline/threefry.py``), so it draws the reference's
    minibatches for any prefetch worker count.

    Policies (device draw only; the host draw is uniform):
      uniform  iid neighbor sampling (the paper's sampler)
      labor    one shared hash key per vertex: overlapping fanouts select
               the same neighbors (LABOR-style correlated draw)
      cv       control-variate sampling: LABOR keys divided by
               ``1 + cv_boost * resident``, preferring vertices with a
               live HEC line; the trainer refreshes residency each epoch
    """
    policy: str = "uniform"         # uniform | labor | cv
    device_draw: bool = False
    cv_boost: float = 4.0           # cv: weight boost for HEC-resident rows

    def __post_init__(self):
        if self.policy not in ("uniform", "labor", "cv"):
            raise ValueError(f"policy must be uniform|labor|cv, "
                             f"got {self.policy!r}")
        if self.policy != "uniform" and not self.device_draw:
            raise ValueError(
                f"policy={self.policy!r} needs device_draw=True "
                f"(the host draw is uniform-only)")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """The minibatch pipeline (``pipeline/``): ``enabled`` makes it the
    training path's source (else the unstaged per-step sampler),
    ``num_workers`` sampling threads (0 = inline), ``prefetch_depth``
    minibatches ahead of the step, ``double_buffer`` (issue batch k+1's
    host-to-device copy before step k reads batch k), ``vectorized`` (the
    vectorized CSR sampler, else the reference's per-row one) and the
    fanout draw (``sampler``).  Every step owns its RNG stream and every
    device draw its seed, so the minibatches are the same for any worker
    count and either staging."""
    enabled: bool = True
    num_workers: int = 1
    prefetch_depth: int = 1
    double_buffer: bool = True
    vectorized: bool = True
    sampler: SamplerConfig = dataclasses.field(
        default_factory=SamplerConfig)

    def __post_init__(self):
        if self.num_workers < 0:
            raise ValueError(f"num_workers must be >= 0 "
                             f"(0 = synchronous), got {self.num_workers}")
        if self.prefetch_depth < 1:
            raise ValueError(
                f"prefetch_depth must be >= 1, got {self.prefetch_depth}")


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    model: str                       # "graphsage" | "gat"
    fanouts: Sequence[int] = (5, 10, 15)   # sampled neighbors per layer (L2..L0)
    hidden_size: int = 256
    num_hidden_layers: int = 2       # => 3 GNN layers total (paper: 3-layer models)
    num_heads: int = 4               # GAT only
    batch_size: int = 1000
    lr: float = 0.003
    dropout: float = 0.5             # training only (serving runs without)
    aggregator: str = "mean"         # graphsage: mean; gat: gcn
    feat_dim: int = 128
    num_classes: int = 172
    hec: HECConfig = dataclasses.field(default_factory=HECConfig)
    pipeline: PipelineConfig = dataclasses.field(
        default_factory=PipelineConfig)

    @property
    def num_layers(self) -> int:
        return self.num_hidden_layers + 1

    @property
    def hidden_width(self) -> int:
        """Width of a hidden layer's output: ``hidden_size``, times
        ``num_heads`` for GAT (its heads are concatenated)."""
        return self.hidden_size * (self.num_heads if self.model == "gat"
                                   else 1)


# Paper-faithful presets (Table 2): GraphSAGE and GAT on ogbn-papers100M.
GRAPHSAGE_PAPERS100M = GNNConfig(
    name="graphsage-papers100m", model="graphsage", lr=0.006,
    feat_dim=128, num_classes=172)
GAT_PAPERS100M = GNNConfig(
    name="gat-papers100m", model="gat", lr=0.001, aggregator="gcn",
    feat_dim=128, num_classes=172)


def small_gnn_config(model: str = "graphsage", **over) -> GNNConfig:
    """CPU-sized preset for tests/examples on synthetic graphs."""
    defaults = dict(
        name=f"{model}-small", model=model, fanouts=(5, 5), hidden_size=64,
        num_hidden_layers=1, batch_size=64, feat_dim=32, num_classes=8,
        lr=0.01, dropout=0.1,
        hec=HECConfig(cache_size=4096, ways=4, life_span=2, push_limit=256,
                      delay=1),
    )
    if model == "gat":
        defaults["aggregator"] = "gcn"
    defaults.update(over)
    return GNNConfig(**defaults)
