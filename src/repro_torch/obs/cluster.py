"""Per-rank telemetry shards -> cluster views (own copy of
``repro/obs/cluster.py``).

The trainer's step and the sharded serve scheduler's round keep their
pre-sum per-rank scalars (``rank_halo_rows``, ``rank_push_rows``, ...)
as ``[R]`` vectors, read on the host with the metrics they already copy
(one device-to-host copy a step): :class:`RankAccumulator` sums them over
an epoch or round window, :func:`publish_rank_series` writes the totals
into rank-labeled registry series (``rank_halo_rows{rank=3}``) and
cluster-view gauges (sum, mean, max, max/mean skew).

Observability never feeds back into computation: the per-rank output is
computed whether or not anyone reads it, so the step's outputs are the
same with the health plane on or off, and only the host-side recording
is gated.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.obs.registry import MetricsRegistry


def skew_ratio(per_rank) -> Optional[float]:
    """max/mean load-imbalance ratio; ``None`` when the mean is zero
    (an idle window has no defined skew — never divide by a cold start)."""
    a = np.asarray(per_rank, np.float64).reshape(-1)
    if a.size == 0:
        return None
    mean = float(a.mean())
    if mean <= 0.0:
        return None
    return float(a.max()) / mean


@dataclasses.dataclass(frozen=True)
class SeriesView:
    """One metric's cluster view for a window: the per-rank breakdown
    plus its sum / mean / max / skew aggregates."""
    name: str
    per_rank: np.ndarray            # [R] float64

    @property
    def sum(self) -> float:
        return float(self.per_rank.sum())

    @property
    def mean(self) -> float:
        return float(self.per_rank.mean()) if self.per_rank.size else 0.0

    @property
    def max(self) -> float:
        return float(self.per_rank.max()) if self.per_rank.size else 0.0

    @property
    def skew(self) -> Optional[float]:
        return skew_ratio(self.per_rank)


class RankAccumulator:
    """Host-side accumulator for per-step ``{name: [R]}`` counter shards.

    ``add`` sums element-wise into the running window; ``finish`` returns
    the window totals and resets.  Values arrive as host arrays: the
    caller reads them with the step's metrics, in one device-to-host
    copy."""

    def __init__(self, num_ranks: int):
        self.num_ranks = int(num_ranks)
        self.totals: Dict[str, np.ndarray] = {}
        self.steps = 0

    def add(self, stats: Dict[str, np.ndarray]):
        for name, arr in stats.items():
            a = np.asarray(arr, np.float64).reshape(-1)
            if a.size != self.num_ranks:
                raise ValueError(
                    f"rank series {name!r} has {a.size} entries, "
                    f"expected {self.num_ranks}")
            t = self.totals.get(name)
            self.totals[name] = a.copy() if t is None else t + a
        self.steps += 1

    def finish(self) -> Dict[str, np.ndarray]:
        out, self.totals, self.steps = self.totals, {}, 0
        return out


def views_of(totals: Dict[str, np.ndarray]) -> Dict[str, SeriesView]:
    return {name: SeriesView(name, np.asarray(arr, np.float64).reshape(-1))
            for name, arr in totals.items()}


def publish_rank_series(reg: MetricsRegistry,
                        totals: Dict[str, np.ndarray],
                        ) -> Dict[str, SeriesView]:
    """Publish one window's per-rank totals into the registry.

    For each metric ``m`` with per-rank vector ``v``:

      * counters ``m{rank=r}`` accumulate ``v[r]`` (the rank-labeled
        series — sums across windows like every other counter),
      * gauges ``cluster_sum/cluster_mean/cluster_max{metric=m}`` carry
        the window aggregates,
      * gauge ``cluster_skew{metric=m}`` carries max/mean — set only when
        defined (zero-mean windows publish no skew).

    Returns the window's :class:`SeriesView`s for detector consumption.
    """
    views = views_of(totals)
    for name in sorted(views):
        v = views[name]
        for r in range(v.per_rank.size):
            reg.counter(name, rank=r).inc(v.per_rank[r])
        reg.gauge("cluster_sum", metric=name).set(v.sum)
        reg.gauge("cluster_mean", metric=name).set(v.mean)
        reg.gauge("cluster_max", metric=name).set(v.max)
        if v.skew is not None:
            reg.gauge("cluster_skew", metric=name).set(v.skew)
    return views


def rank_series(reg: MetricsRegistry, name: str,
                num_ranks: int) -> Optional[np.ndarray]:
    """Read back the accumulated rank-labeled counter series as ``[R]``,
    or ``None`` if no rank of it was ever published."""
    vals = [reg.value(name, default=np.nan, rank=r) for r in range(num_ranks)]
    a = np.asarray(vals, np.float64)
    if np.isnan(a).all():
        return None
    return np.nan_to_num(a, nan=0.0)
