"""Embedding quality plane: staleness telemetry, the online exactness
audit, and convergence observability (own copy of
``repro/obs/quality.py``).

Three instruments, all host-side consumers of state the device already
holds (no new collective, and the step's outputs are the same bits with
the plane off or on):

  * **staleness telemetry** — per-layer age histograms read off the
    ``HECState.age`` / ``HotTierState.age`` tensors at epoch or round
    boundaries, published as ``hec_stale_age_l{l}`` /
    ``hot_replica_age`` histograms (with mean, max and filled-fraction
    gauges),
  * the **online exactness audit** — every ``audit_interval`` epochs (and
    on demand in serving through the schedulers' ``audit()``), up to
    ``audit_samples`` cached vertices per layer are sampled, their exact
    ``h^l`` recomputed by the offline-inference path, and the relative
    L2 error published as ``hec_audit_err_l{l}`` (and the hot tier's
    replica divergence as ``hot_audit_err``).  A cache freshly warmed
    from the offline embeddings audits to exactly 0.0,
  * **convergence telemetry** — each epoch's loss, accuracy and gradient
    norm into the registry's event log (and so the JSONL sink).

Layers are labeled by the ``h^l`` they cache: the trainer's ``hec[l]``
holds ``h^l`` for ``l = 0..L-1`` (``l = 0`` is the input features, exact
at any age); the serving caches hold ``h^1..h^L``, so serving layer
``k`` (0-based) publishes as ``l = k + 1``.  Each audit's mean error goes
to :meth:`HealthPlane.observe_audit`, whose
:class:`~repro_torch.obs.detect.QualityBudgetDetector` (armed by
``HealthConfig.quality_budget``) dumps ``FLIGHT_quality.json`` after
``quality_window`` audits over budget.

Cache states are read from wherever they lie (a copy to the host where
they are on the card); a trainer's per-rank list of states flattens rank
by rank, as the reference's stacked ``[R, ...]`` state does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.obs.registry import MetricsRegistry, PromFileWriter

_EPS = 1e-12


# ---------------------------------------------------------------------------
# pure helpers
# ---------------------------------------------------------------------------
def relative_l2(cached, exact, eps: float = _EPS) -> np.ndarray:
    """Row-wise relative L2 error ``||cached - exact|| / max(||exact||, eps)``.

    Bit-equal rows subtract to exact zeros, so their error is EXACTLY
    0.0 (no epsilon fuzz in the numerator) — the fresh-cache audit
    contract.  All-zero exact rows fall back to the absolute norm over
    ``eps`` (still exactly 0.0 when cached matches)."""
    c = np.asarray(cached, np.float64)
    e = np.asarray(exact, np.float64)
    assert c.shape == e.shape, (c.shape, e.shape)
    num = np.linalg.norm(c - e, axis=-1)
    den = np.maximum(np.linalg.norm(e, axis=-1), eps)
    return num / den


def host(x: torch.Tensor) -> np.ndarray:
    """A tensor, on any device, as a host numpy array."""
    return x.detach().cpu().numpy()


def _parts(states) -> list:
    return list(states) if isinstance(states, (list, tuple)) else [states]


def _flat(states, field: str) -> np.ndarray:
    """``field`` of a state, or of a list of per-rank states concatenated
    rank by rank, flattened on the host."""
    return np.concatenate([host(getattr(st, field)).reshape(-1)
                           for st in _parts(states)])


def _rows(states, idx: np.ndarray, dim: int) -> np.ndarray:
    """The value rows at flat line indices ``idx`` (in that order),
    gathered where the values lie and only those copied to the host."""
    out = np.zeros((len(idx), dim), np.float32)
    start = 0
    for st in _parts(states):
        vals = st.values.reshape(-1, dim)
        end = start + vals.shape[0]
        pick = np.flatnonzero((idx >= start) & (idx < end))
        if len(pick):
            local = torch.as_tensor(idx[pick] - start, dtype=torch.long,
                                    device=vals.device)
            out[pick] = host(vals.index_select(0, local))
        start = end
    return out


def cache_entries(state, sample: Optional[int] = None, rng=None
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side ``(vids, values, ages)`` of a cache state's valid lines.

    Reads any state with tensors ``tags [..., nsets, ways]``, ``age
    [..., nsets, ways]`` and ``values [..., nsets, ways, dim]`` — a
    :class:`~repro_torch.cache.hec.HECState`, stacked ``[R, ...]`` or not,
    or a list of per-rank states (each rank's replica of a vid is its own
    auditable entry).  ``sample`` caps the returned count (uniform without
    replacement, via ``rng``)."""
    dim = _parts(state)[0].values.shape[-1]
    tags = _flat(state, "tags")
    ages = _flat(state, "age")
    idx = np.flatnonzero(tags >= 0)
    if sample is not None and len(idx) > sample:
        rng = rng or np.random.default_rng(0)
        idx = rng.choice(idx, size=sample, replace=False)
    vals = _rows(state, idx, dim)
    return tags[idx].astype(np.int64), vals, ages[idx].astype(np.int64)


def valid_ages(state) -> np.ndarray:
    """Ages of a cache state's (or per-rank list's) tagged lines,
    flattened host-side."""
    tags = _flat(state, "tags")
    ages = _flat(state, "age")
    return ages[tags >= 0].astype(np.int64)


# ---------------------------------------------------------------------------
# audit report
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class AuditReport:
    """One exactness audit: per-layer error stats + the scalar the
    budget detector consumes (``mean_err`` over every audited entry of
    every layer; ``None`` when nothing was cached yet — no signal)."""
    epoch: int
    source: str                               # "train" | "serve" | ...
    per_layer: Dict[int, dict]                # l -> {n, err_mean, ...}
    hot: Optional[dict] = None                # replica divergence stats
    mean_err: Optional[float] = None

    def to_json(self) -> dict:
        return {"epoch": self.epoch, "source": self.source,
                "mean_err": self.mean_err,
                "layers": {str(l): v for l, v in self.per_layer.items()},
                "hot": self.hot}

    def hidden_mean_err(self) -> Optional[float]:
        """Mean error over hidden layers only (``l >= 1``) — layer 0
        caches raw features (exact at any age) and would dilute a
        staleness-sensitivity figure."""
        errs = [(v["err_mean"], v["n"]) for l, v in self.per_layer.items()
                if l >= 1 and v["n"]]
        if not errs:
            return None
        w = sum(n for _, n in errs)
        return float(sum(e * n for e, n in errs) / w)


def _err_stats(err: np.ndarray, ages: Optional[np.ndarray]) -> dict:
    out = {"n": int(err.size)}
    if err.size:
        out.update(
            err_mean=float(err.mean()),
            err_p99=float(np.percentile(err, 99)),
            err_max=float(err.max()))
        if ages is not None and len(ages):
            out["age_mean"] = float(np.asarray(ages).mean())
    return out


# ---------------------------------------------------------------------------
# the plane
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class QualityConfig:
    """Knobs for one :class:`QualityPlane`.

    ``audit_interval = 0`` (the default) disables the exactness audit —
    the expensive instrument; staleness + convergence telemetry are
    always-on host reads.  ``audit_interval = k`` audits at the end of
    every k-th epoch (epochs ``k-1, 2k-1, ...``)."""
    enabled: bool = True
    audit_interval: int = 0        # epochs between audits (0 = off)
    audit_samples: int = 256       # K cached vertices sampled per layer
    seed: int = 0                  # audit sampling RNG (independent of
    #                                the training RNG: audits never
    #                                perturb the training trajectory)


class QualityPlane:
    """The per-process quality coordinator the trainer and both serve
    schedulers wire in (``quality=`` argument).

    Pure host-side bookkeeping: every method reads existing device state
    (one transfer) or numbers already on the host, and publishes into
    the active registry.  ``health`` (a :class:`HealthPlane`) receives
    each audit's mean error for budget detection."""

    def __init__(self, cfg: Optional[QualityConfig] = None,
                 health=None,
                 registry: Optional[MetricsRegistry] = None,
                 prom: Optional[PromFileWriter] = None):
        self.cfg = cfg or QualityConfig()
        self.enabled = self.cfg.enabled
        self.health = health
        self._registry = registry
        self.prom = prom
        self.rng = np.random.default_rng(self.cfg.seed)
        self.audits_run = 0
        self.last_report: Optional[AuditReport] = None
        self.reports: List[AuditReport] = []

    # -- plumbing -------------------------------------------------------------
    def _reg(self) -> MetricsRegistry:
        if self._registry is not None:
            return self._registry
        from repro_torch import obs    # deferred: obs/__init__ imports us
        return obs.get().registry

    def should_audit(self, epoch: int) -> bool:
        iv = self.cfg.audit_interval
        return bool(self.enabled and iv > 0 and (epoch + 1) % iv == 0)

    def sample(self, state) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Sample up to ``audit_samples`` valid entries of a cache state
        (host-side read of tags/values/ages — no device mutation)."""
        return cache_entries(state, sample=self.cfg.audit_samples,
                             rng=self.rng)

    # -- instrument 3: convergence telemetry ----------------------------------
    def observe_epoch(self, epoch: int, metrics: Optional[dict] = None):
        """Record one epoch's convergence point (loss/acc/grad-norm) into
        the registry event log + gauges, and service the prom writer."""
        if not self.enabled:
            return
        reg = self._reg()
        if reg.enabled and metrics:
            payload = {k: float(metrics[k])
                       for k in ("loss", "acc", "grad_norm", "examples")
                       if k in metrics}
            reg.log_event("convergence", epoch=int(epoch), **payload)
            for k, v in payload.items():
                reg.gauge(f"train_{k}").set(v)
        if self.prom is not None and reg.enabled:
            self.prom.maybe_write(reg)

    # -- instrument 1: staleness telemetry ------------------------------------
    def publish_staleness(self, states: Sequence, layer_of=None,
                          prefix: str = "hec"):
        """Per-layer age histograms + gauges from the live cache states.

        ``states[i]`` is an HECState (stacked or not) or a list of
        per-rank states; ``layer_of(i)``
        maps list position to the published ``h^l`` index (default:
        identity — the trainer's layout; serving passes ``i + 1``)."""
        if not self.enabled:
            return
        reg = self._reg()
        if not reg.enabled:
            return
        for i, st in enumerate(states):
            l = layer_of(i) if layer_of is not None else i
            ages = valid_ages(st)
            tags = _flat(st, "tags")
            frac = float((tags >= 0).mean()) if tags.size else 0.0
            reg.gauge(f"{prefix}_filled_frac_l{l}").set(frac)
            if not len(ages):
                continue
            reg.histogram(f"{prefix}_stale_age_l{l}").observe_many(ages)
            reg.gauge(f"{prefix}_stale_age_mean_l{l}").set(ages.mean())
            reg.gauge(f"{prefix}_stale_age_max_l{l}").set(ages.max())

    # -- instrument 2: the exactness audit ------------------------------------
    def run_audit(self, epoch: int,
                  layer_samples: Sequence[Tuple],
                  hot_samples: Optional[Tuple] = None,
                  source: str = "train") -> AuditReport:
        """Score one audit's sampled (cached, exact) pairs and publish.

        ``layer_samples``: ``(l, cached [n, d], exact [n, d], ages [n])``
        per layer — the caller glue already sampled the cache (via
        :meth:`sample`) and gathered the exact reference rows from the
        offline-inference output.  ``hot_samples``: optional
        ``(cached, exact)`` pair — or a list of per-layer pairs (hot-tier
        layers cache different widths, so their error *vectors* are
        concatenated, never the rows) — over valid replica rows."""
        reg = self._reg()
        per_layer: Dict[int, dict] = {}
        all_errs: List[np.ndarray] = []
        for l, cached, exact, ages in layer_samples:
            err = relative_l2(cached, exact) if len(cached) \
                else np.zeros(0, np.float64)
            per_layer[int(l)] = _err_stats(err, ages)
            if err.size:
                all_errs.append(err)
                if reg.enabled:
                    reg.histogram(f"hec_audit_err_l{l}").observe_many(err)
                    reg.gauge(f"hec_audit_err_mean_l{l}").set(err.mean())
                    reg.gauge(f"hec_audit_err_max_l{l}").set(err.max())
        hot = None
        if hot_samples is not None:
            pairs = hot_samples if isinstance(hot_samples, list) \
                else [hot_samples]
            herrs = [relative_l2(c, e) for c, e in pairs if len(c)]
            if herrs:
                herr = np.concatenate(herrs)
                hot = _err_stats(herr, None)
                all_errs.append(herr)
                if reg.enabled:
                    reg.histogram("hot_audit_err").observe_many(herr)
                    reg.gauge("hot_audit_err_mean").set(herr.mean())
        mean_err = float(np.concatenate(all_errs).mean()) \
            if all_errs else None
        report = AuditReport(epoch=int(epoch), source=source,
                             per_layer=per_layer, hot=hot,
                             mean_err=mean_err)
        if reg.enabled:
            reg.log_event("audit", **report.to_json())
            reg.counter("quality_audits").inc()
        if self.health is not None and getattr(self.health, "enabled",
                                               False):
            self.health.observe_audit(epoch, mean_err)
        self.audits_run += 1
        self.last_report = report
        self.reports.append(report)
        return report

    # -- reporting ------------------------------------------------------------
    def summary(self) -> dict:
        last = self.last_report
        return {
            "enabled": self.enabled,
            "audits_run": self.audits_run,
            "audit_interval": self.cfg.audit_interval,
            "last_mean_err": last.mean_err if last else None,
            "last_hidden_err": last.hidden_mean_err() if last else None,
            "prom_writes": self.prom.writes if self.prom else 0,
        }
