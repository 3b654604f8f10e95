"""Detectors over cluster views — the health plane's decision layer
(own copy of ``repro/obs/detect.py``).

Each detector consumes one window (epoch or serve round) of aggregated
telemetry and answers "is something persistently wrong?".  Shared
conventions, chosen so a noisy single window can never page anyone:

  * **windowed persistence** — a condition must hold for ``window``
    CONSECUTIVE updates before a :class:`Detection` is emitted; any
    clean window resets the streak;
  * **rising-edge firing** — a sustained condition fires exactly once
    (when the streak first reaches ``window``), not once per window, so
    a long-lived straggler produces one flight dump, not hundreds;
  * **zero-denominator guard** — windows with no data (zero median step
    time, zero halo rows, empty latency histogram) produce *no signal*:
    the streak resets and nothing fires.  Cold starts are silent, never
    NaN (see ``MetricsRegistry.rate_or_none`` — same contract).

All detectors are pure host-side consumers: they read numpy vectors and
histograms, never devices, and are exercised with injected traces in
``tests/test_torch_health.py`` against the reference's (fire on a planted
straggler/skew/drift, stay silent on clean runs).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.obs.registry import Histogram


@dataclasses.dataclass
class Detection:
    """One fired detector: what, where, how bad, and the threshold it
    crossed.  ``reason`` is a filesystem-safe slug used for the flight
    recorder's ``FLIGHT_<reason>.json`` filename."""
    detector: str
    reason: str
    message: str
    epoch: int
    rank: int = -1                  # -1 = cluster-wide
    value: Optional[float] = None
    threshold: Optional[float] = None

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class _Streaks:
    """Per-rank consecutive-window counters with rising-edge detection."""

    def __init__(self, n: int = 1):
        self.counts = np.zeros(n, np.int64)

    def update(self, over: np.ndarray, window: int) -> np.ndarray:
        """Advance one window; returns the boolean mask of ranks whose
        streak just reached ``window`` (the rising edge)."""
        over = np.asarray(over, bool)
        if over.shape != self.counts.shape:
            self.counts = np.zeros(over.shape, np.int64)
        prev = self.counts.copy()
        self.counts = np.where(over, self.counts + 1, 0)
        return (self.counts >= window) & (prev < window)

    def reset(self):
        self.counts[:] = 0


class StragglerDetector:
    """Rank step-time > ``k`` · median(step times) for ``window``
    consecutive epochs.  The in-process trainer runs every rank on one
    clock and feeds a uniform wall time, so this never fires locally; a
    multi-process deployment feeds genuinely per-rank timings."""

    name = "straggler"

    def __init__(self, k: float = 2.0, window: int = 3):
        self.k = float(k)
        self.window = int(window)
        self._streaks = _Streaks()

    def update(self, epoch: int, step_s_per_rank) -> List[Detection]:
        if step_s_per_rank is None:
            self._streaks.reset()
            return []
        t = np.asarray(step_s_per_rank, np.float64).reshape(-1)
        if t.size < 2 or not np.isfinite(t).all():
            self._streaks.reset()
            return []
        med = float(np.median(t))
        if med <= 0.0:                      # idle window: no signal
            self._streaks.reset()
            return []
        fired = self._streaks.update(t > self.k * med, self.window)
        return [Detection(
            detector=self.name, reason=f"straggler_r{r}", epoch=epoch,
            rank=int(r), value=float(t[r] / med), threshold=self.k,
            message=(f"rank {r} step time {t[r]:.4f}s = "
                     f"{t[r] / med:.2f}x median ({med:.4f}s) for "
                     f"{self.window} consecutive epochs"))
            for r in np.flatnonzero(fired)]


class LoadSkewDetector:
    """max/mean of a per-rank load vector (halo rows by default) above
    ``threshold`` for ``window`` consecutive windows."""

    name = "load_skew"

    def __init__(self, threshold: float = 4.0, window: int = 3,
                 metric: str = "rank_halo_rows"):
        self.threshold = float(threshold)
        self.window = int(window)
        self.metric = metric
        self.last_skew: Optional[float] = None
        self._streaks = _Streaks()

    def update(self, epoch: int, per_rank) -> List[Detection]:
        from repro_torch.obs.cluster import skew_ratio
        self.last_skew = skew_ratio(per_rank)
        if self.last_skew is None:          # idle window: no signal
            self._streaks.reset()
            return []
        fired = self._streaks.update(
            np.asarray([self.last_skew > self.threshold]), self.window)
        if not fired[0]:
            return []
        return [Detection(
            detector=self.name, reason="load_skew", epoch=epoch,
            value=self.last_skew, threshold=self.threshold,
            message=(f"{self.metric} skew max/mean = {self.last_skew:.2f} "
                     f"> {self.threshold:.2f} for {self.window} "
                     f"consecutive windows"))]


class EdgeCutDriftDetector:
    """Observed per-rank halo-row distribution drifting away from the
    plan-time expectation (``ExchangePlan.expected_inbound_rows``).

    Drift is the total-variation distance between the observed and the
    expected per-rank row *fractions* — 0 means the live exchange matches
    the plan exactly, 1 means completely disjoint mass.  Sustained drift
    above ``tolerance`` is the re-partitioning trigger the streaming-
    graph roadmap item consumes."""

    name = "edge_cut_drift"

    def __init__(self, expected, tolerance: float = 0.25, window: int = 3):
        exp = np.asarray(expected, np.float64).reshape(-1)
        tot = exp.sum()
        self.expected_frac = exp / tot if tot > 0 else None
        self.tolerance = float(tolerance)
        self.window = int(window)
        self.last_drift: Optional[float] = None
        self._streaks = _Streaks()

    def update(self, epoch: int, observed_per_rank) -> List[Detection]:
        if self.expected_frac is None:      # plan expects no halo traffic
            return []
        obs = np.asarray(observed_per_rank, np.float64).reshape(-1)
        tot = obs.sum()
        if obs.size != self.expected_frac.size or tot <= 0.0:
            self.last_drift = None
            self._streaks.reset()
            return []
        drift = 0.5 * float(np.abs(obs / tot - self.expected_frac).sum())
        self.last_drift = drift
        fired = self._streaks.update(
            np.asarray([drift > self.tolerance]), self.window)
        if not fired[0]:
            return []
        return [Detection(
            detector=self.name, reason="edge_cut_drift", epoch=epoch,
            value=drift, threshold=self.tolerance,
            message=(f"halo-row distribution drifted {drift:.3f} (total "
                     f"variation) from plan expectation > "
                     f"{self.tolerance:.3f} for {self.window} windows — "
                     f"re-partitioning signal"))]


class SLOBurnDetector:
    """Serve latency burning its SLO: the fraction of window samples
    above the p99 target exceeds ``burn_threshold`` (i.e. the tail is
    fatter than the SLO budget allows) for ``window`` consecutive
    rounds.  Reads the existing ``serve_latency_s`` histogram."""

    name = "slo_burn"

    def __init__(self, target_p99_s: float, burn_threshold: float = 0.05,
                 window: int = 2, min_samples: int = 20):
        self.target_p99_s = float(target_p99_s)
        self.burn_threshold = float(burn_threshold)
        self.window = int(window)
        self.min_samples = int(min_samples)
        self.last_burn: Optional[float] = None
        self._streaks = _Streaks()

    def update(self, epoch: int, hist: Histogram) -> List[Detection]:
        if hist is None or len(hist.samples) < self.min_samples:
            self.last_burn = None           # too few samples: no signal
            self._streaks.reset()
            return []
        a = np.asarray(hist.samples, np.float64)
        burn = float((a > self.target_p99_s).mean())
        self.last_burn = burn
        fired = self._streaks.update(
            np.asarray([burn > self.burn_threshold]), self.window)
        if not fired[0]:
            return []
        p99 = float(np.percentile(a, 99))
        return [Detection(
            detector=self.name, reason="slo_burn", epoch=epoch,
            value=burn, threshold=self.burn_threshold,
            message=(f"{burn * 100:.1f}% of serve latencies above the "
                     f"{self.target_p99_s * 1e3:.1f}ms p99 target "
                     f"(window p99 {p99 * 1e3:.1f}ms) for {self.window} "
                     f"consecutive rounds"))]


class QualityBudgetDetector:
    """Embedding-quality budget breach: the exactness audit's mean
    relative-L2 error above ``budget`` for ``window`` CONSECUTIVE audits.

    Fed by :meth:`HealthPlane.observe_audit` (the quality plane reports
    each audit's mean error there).  Epochs without an audit — or audits
    that sampled zero cached entries (``mean_err=None``) — carry no
    signal: the streak resets and nothing fires, exactly like the other
    detectors' zero-denominator guard.  The ``reason`` slug is
    ``quality``, so a sustained breach dumps ``FLIGHT_quality.json``."""

    name = "quality_budget"

    def __init__(self, budget: float, window: int = 2):
        self.budget = float(budget)
        self.window = int(window)
        self.last_err: Optional[float] = None
        self._streaks = _Streaks()

    def update(self, epoch: int, mean_err: Optional[float]) \
            -> List[Detection]:
        if mean_err is None or not np.isfinite(mean_err):
            self.last_err = None            # no audit data: no signal
            self._streaks.reset()
            return []
        self.last_err = float(mean_err)
        fired = self._streaks.update(
            np.asarray([self.last_err > self.budget]), self.window)
        if not fired[0]:
            return []
        return [Detection(
            detector=self.name, reason="quality", epoch=epoch,
            value=self.last_err, threshold=self.budget,
            message=(f"audit mean relative-L2 error {self.last_err:.4f} "
                     f"over the quality budget {self.budget:.4f} for "
                     f"{self.window} consecutive audits — cached "
                     f"embeddings have drifted past the error budget"))]


class HotTierDecayDetector:
    """Hot-tier efficacy decaying: the window's hot-hit rate (hot hits /
    halo rows) falling below ``decay`` · its historical peak for
    ``window`` consecutive windows — the re-seed signal for adaptive hot
    sets.  Windows with zero halo rows carry no signal."""

    name = "hot_tier_decay"

    def __init__(self, decay: float = 0.5, window: int = 3,
                 min_peak: float = 0.05):
        self.decay = float(decay)
        self.window = int(window)
        self.min_peak = float(min_peak)
        self.peak: Optional[float] = None
        self.last_rate: Optional[float] = None
        self._streaks = _Streaks()

    def update(self, epoch: int, hot_hits: float,
               halo_rows: float) -> List[Detection]:
        if halo_rows <= 0.0:                # no halo traffic: undefined rate
            self.last_rate = None
            self._streaks.reset()
            return []
        rate = float(hot_hits) / float(halo_rows)
        self.last_rate = rate
        decayed = (self.peak is not None and self.peak >= self.min_peak
                   and rate < self.decay * self.peak)
        self.peak = rate if self.peak is None else max(self.peak, rate)
        fired = self._streaks.update(np.asarray([decayed]), self.window)
        if not fired[0]:
            return []
        return [Detection(
            detector=self.name, reason="hot_tier_decay", epoch=epoch,
            value=rate, threshold=self.decay * self.peak,
            message=(f"hot-tier hit rate {rate:.3f} below "
                     f"{self.decay:.2f}x peak ({self.peak:.3f}) for "
                     f"{self.window} consecutive windows — re-seed the "
                     f"hot set"))]
