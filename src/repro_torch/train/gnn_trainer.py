"""Distributed minibatch GNN training (GraphSAGE or GAT; paper Algorithms
1 and 2) — counterpart of ``repro/train/gnn_trainer.py``.

One paper "rank" owns a graph partition, a HEC per layer and an AEP
in-flight queue; the model parameters are replicated and the gradients
all-reduced.  Here R ranks run in one process on one device: the step is
a sequence of stages over all ranks, with the collectives of a
:class:`~repro_torch.comm.collective.StackedCollective` between them,
where the reference runs one ``shard_map`` program per rank.

Modes, as the reference's ``DistTrainer.mode``:

  aep   the paper's: HEC + delayed push (DistGNN-MB), optionally with the
        replicated hot tier (``HECConfig.hot_size``/``hot_budget``)
  sync  DistDGL-like baseline: the first ``nc`` layer-0 halos of every
        rank fetched fresh from their owners each step, by a blocking
        request/response all_to_all pair
  drop  LLCG-like: halo rows are dropped at every layer

One step (``DistTrainer.train_step``, the reference's ``_rank_step``):

  1. ``aep``: per rank, consume the delayed push: tick every layer's HEC
     (and the hot tier's replica) and store the queue's slot 0, in place;
  2. every rank's layer-0 features; ``sync`` fetches its halos, ``aep``
     substitutes hot-tier and HEC hits (the HEC probe + load kernel);
     a rank with the ``nan_step`` fault code then multiplies them by NaN;
  3. per rank and layer, the model's layer with the hash dropout
     (GraphSAGE: the AGG and UPDATE kernels; GAT: the projection in
     ``torch.addmm`` and the GAT AGG kernel), then the halo hook: in
     ``aep`` hot-tier then HEC hits replace halo rows by ``torch.where``,
     so substituted rows get no gradient; otherwise halos turn invalid;
  4. per rank, the masked cross-entropy over the seeds;
  5. per rank, the backward (the layers' gradient kernels and
     ``torch.matmul``) on the main stream; in ``aep`` with
     ``overlap=True`` (the paper's scheme) each rank's push selection
     (and hot-tier broadcast segment) is dispatched just before its
     backward, and every rank's selection then goes in ONE fused
     all_to_all; on the card the push runs on the trainer's push stream,
     which first waits for the forward, so it overlaps the backward (when
     the resilience plane arms the step, each rank's selection drops its
     non-finite rows and takes its wire fault before the send:
     ``HaloExchangeEngine.filter_push``);
  6. the example-weighted gradient all-reduce;
  7. Adam with a global-norm clip of 1.0, in place; armed, the NaN/Inf
     guard then keeps the old parameters and moments (a device select)
     when the loss or a gradient is not finite, and the step's metrics
     are zero with ``skipped`` 1;
  8. ``aep`` with ``overlap=False`` (the reference's legacy schedule):
     the push, inline on the main stream after Adam.

Both schedules move the same data.  Every reader of the push (the next
step's consume, the push metrics, ``evaluate``, ``_cv_residency``, a
checkpoint) first makes its stream wait on the push stream's event.

Minibatches come from the reference's sources: by default a
:class:`~repro_torch.pipeline.staging.MinibatchPipeline` (vectorized
sampler, prefetch thread, double-buffered staging), with
``train_epochs(pipeline=None)`` the unstaged per-step sampler
(``train/data.py:gnn_epoch_iterator``, ``sample_step``).

With ``cfg.pipeline.sampler.device_draw`` the minibatches' fanout draw
runs on ``device`` (kernel I on the card); under the ``cv`` policy
``train_epochs`` refreshes each rank's HEC residency, which the draw's
weights read, at the start of every epoch.

The HEC states, the hot tier and the queues are updated in place where
the reference returns new ones.  ``evaluate`` runs each batch from the
training state as it is: it keeps the HEC tags and ages (and the tier's
ages), journals the value rows the consume overwrites, and puts all of
it back after the batch.

The resilience plane (``resilience=``, a ``resilience.ResiliencePlane``)
is the reference's: when it is step-armed (``nan_guard`` or a fault
schedule) ``train_epochs`` gives each step its per-rank fault codes
(host ints, so the faults are host branches: with every code 0 the
step computes the unarmed step's bits) and the step runs the guard; it
keeps a copy of the parameters and moments for it, and Adam's count,
a host int, goes back by one when the step's one host copy reads
``skipped``.  A checkpointing plane saves the whole state at epoch
boundaries (after joining the push); the plane's injector reaches the
minibatch pipeline (``kill_prefetch``).  ``evaluate`` runs clean.

The health and quality planes (``health=``, ``quality=``) only read:
every step computes its per-rank series (``rank_stats``: examples,
sampled rows, halo rows, HEC and hot hits, pushed rows and bytes, each
``[R]`` before the sum over ranks) on the device whether or not a plane
is on, and copies them to the host with the step's metrics in ONE
device-to-host copy; ``train_epochs`` sums them per epoch, publishes
rank-labeled series and feeds the health plane's detectors, and the
quality plane reads the caches' ages and, on its interval, runs
:meth:`DistTrainer.audit` (sampled cached rows against exact offline
embeddings).  So the step's outputs, and its kernel launches, are the
same with the planes off or on.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.cache import hec as hec_lib
from repro_torch.cache import hot_tier as hot_lib
from repro_torch.comm.collective import StackedCollective
from repro_torch.comm.engine import HaloExchangeEngine
from repro_torch.comm.plan import _pad_stack, build_exchange_plan
from repro_torch.configs.gnn import GNNConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graph.partition import PartitionSet
from repro_torch.graph.sampling import sample_blocks
from repro_torch.models.gnn import build_model
from repro_torch.pipeline import threefry
from repro_torch.pipeline.staging import (MinibatchPipeline,
                                          minibatch_to_device)
from repro_torch.pipeline.vectorized_sampler import stack_ranks
from repro_torch.resilience.inject import CODE_NAN_STEP
from repro_torch.train import optimizer as opt_lib

PushUniforms = Callable[[int, int, Sequence[int]], torch.Tensor]
MODES = ("aep", "sync", "drop")


def layer_dims(cfg: GNNConfig) -> List[int]:
    """Embedding dim held in HEC_l for l = 0..L-1 (inputs + hidden)."""
    return [cfg.feat_dim] + [cfg.hidden_width] * (cfg.num_layers - 1)


def build_dist_data(ps: PartitionSet, cfg: GNNConfig, device) -> dict:
    """Rank-stacked ``[R, ...]`` tables on ``device``: features, labels,
    solid counts, VID_p -> VID_o maps and the exchange plan's tables (the
    push contract mask, the sorted owner tables and, with
    ``cfg.hec.hot_size``, the hot set) — built once per partitioning,
    never per step."""
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return {
        "features": t(_pad_stack([p.features for p in ps.parts], 0.0)),
        "labels": t(_pad_stack([p.labels.astype(np.int32)
                                for p in ps.parts], 0)),
        "num_solid": t(np.array([p.num_solid for p in ps.parts], np.int32)),
        "vid_o": t(_pad_stack([p.vid_p_to_o().astype(np.int32)
                               for p in ps.parts], -1)),
        **build_exchange_plan(ps, host_indices=False,
                              hot_size=cfg.hec.hot_size).device_tables(
                                  device),
    }


def sample_step(ps: PartitionSet, cfg: GNNConfig, seed_lists,
                rng: np.random.Generator) -> dict:
    """One synchronized host ``[R, ...]`` minibatch by the reference's
    per-row sampler (``sample_blocks``, drawing from ``rng`` rank by
    rank); the caller stages it."""
    return stack_ranks([sample_blocks(ps.parts[r], seed_lists[r],
                                      cfg.fanouts, rng, cfg.batch_size)
                        for r in range(ps.num_parts)])


def _epoch_mean(ep_metrics: List[dict]) -> dict:
    """Loss/acc weighted by real example count (padded empty batches weigh
    nothing), other per-step metrics plain-averaged, and the epoch's hit
    rates through an epoch-local registry (``obs.hit_rate_metrics``): per
    layer ``hec_hit_rate_l{l}`` = summed hits over summed halos and, with
    the hot tier, ``hot_hit_rate_l{l}`` over the same halos (both absent
    when no halo row was looked up)."""
    if not ep_metrics:                   # zero-step epoch: no train seeds
        return {"examples": 0.0, "loss": 0.0, "acc": 0.0}
    w = np.array([m.get("examples", 1.0) for m in ep_metrics], np.float64)
    total = w.sum()
    out = {}
    for key in ep_metrics[0]:
        vals = np.array([m[key] for m in ep_metrics], np.float64)
        if key in ("loss", "acc"):
            out[key] = float((vals * w).sum() / max(total, 1.0))
        elif key == "examples":
            out[key] = float(total)
        else:
            out[key] = float(vals.mean())
    # part of the history, not telemetry: on whatever the runtime's state
    reg = obs.MetricsRegistry(enabled=True)
    for m in ep_metrics:
        for key, v in m.items():
            if key.startswith(("hec_hits_l", "hec_halos_l", "hot_hits_l")):
                reg.counter(key).inc(v)
    out.update(obs.hit_rate_metrics(reg))
    return out


def default_push_uniforms(device: torch.device,
                          base_seed: int = 7) -> PushUniforms:
    """The reference's selection uniforms in [1e-6, 1), bit for bit:
    ``jax.random.uniform(fold_in(fold_in(PRNGKey(base_seed), seed), rank),
    shape, minval=1e-6, maxval=1.0)`` (``repro/comm/engine.py:
    select_push`` with 7, ``select_hot_push`` with 11), drawn on
    ``device`` by the tensor Threefry of ``pipeline/threefry.py``."""
    def draw(seed: int, rank: int, shape: Sequence[int]) -> torch.Tensor:
        k = threefry.fold_in(threefry.fold_in(threefry.key(base_seed),
                                              int(seed) & 0xFFFFFFFF), rank)
        return threefry.uniform(k, shape, 1e-6, 1.0, device)
    return draw


@dataclasses.dataclass
class RankInputs:
    """One rank's minibatch as the forward reads it: per layer the nodes
    (VID_p), masks and VID_o, and the layer-0 input (``sync``: with the
    fetched halo rows, ``got`` marking them)."""
    nodes: List[torch.Tensor]
    masks: List[torch.Tensor]
    vid_o_nodes: List[torch.Tensor]
    is_halo0: torch.Tensor
    h0: torch.Tensor
    valid0: torch.Tensor
    got: Optional[torch.Tensor] = None


@dataclasses.dataclass
class RankForward:
    """One rank's forward: the loss to differentiate and what the push
    and the metrics read."""
    loss: torch.Tensor
    nll_sum: torch.Tensor
    correct: torch.Tensor
    n_valid: torch.Tensor
    captured: List
    hits: List
    nodes0: torch.Tensor
    mask0: torch.Tensor
    vid0: torch.Tensor


@dataclasses.dataclass
class DistTrainer:
    """R-rank GNN trainer (``cfg.model``) in ``mode`` (aep | sync | drop)
    on one device.

    ``push_uniforms(seed, rank, (R, N0))`` gives the AEP selection's
    uniforms for a step (default: :func:`default_push_uniforms`, the
    reference's ``PRNGKey(7)`` stream); ``hot_uniforms(seed, rank,
    (N0,))`` is the hot tier's, the reference's ``PRNGKey(11)`` stream.
    ``overlap`` (``aep``): push between the forward and the backward, on
    the card on ``push_stream`` (else inline after the backward).
    ``step_log`` keeps every training step's metrics and ``rank_stats``
    the last step's per-rank series.  ``health`` (an ``obs.HealthPlane``)
    and ``quality`` (an ``obs.QualityPlane``) are the planes, read-only
    on the training state; ``resilience`` (a
    ``resilience.ResiliencePlane``) the fault codes, the NaN/Inf step
    guard and the epoch checkpoints."""
    cfg: GNNConfig
    num_ranks: int
    mode: str = "aep"
    device: DeviceLike = None
    push_uniforms: Optional[PushUniforms] = None
    overlap: bool = True
    health: Optional["obs.HealthPlane"] = None
    quality: Optional["obs.QualityPlane"] = None
    resilience: Optional[object] = None

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got "
                             f"{self.mode!r}")
        self.device = resolve_device(self.device)
        self.comm = StackedCollective(self.num_ranks)
        h = self.cfg.hec
        self.engine = HaloExchangeEngine(self.num_ranks, self.cfg.num_layers,
                                         h.push_limit, h.delay, self.comm,
                                         hot_budget=h.hot_budget)
        if self.push_uniforms is None:
            self.push_uniforms = default_push_uniforms(self.device)
        self.hot_uniforms = default_push_uniforms(self.device, 11)
        self.push_stream = (torch.cuda.Stream(self.device)
                            if self.overlap and self.mode == "aep"
                            and self.device.type == "cuda" else None)
        self._pushed = None            # the push stream's last event
        self.step_log: List[dict] = []
        self.rank_stats: dict = {}

    # -- state ---------------------------------------------------------------
    def init_state(self, seed: int = 0, params: Optional[dict] = None,
                   dist_data: Optional[dict] = None) -> dict:
        """Fresh state: ``cfg.model``'s model (the reference's weights
        from ``jax.random.key(seed)``, or its ``{"layers": [...]}`` tree
        ``params``), Adam, one empty HEC per (layer, rank) in every mode,
        empty in-flight queues and, in ``aep`` with a hot budget, one
        empty hot-tier replica per layer stacked over the ranks.

        The tier follows the reference's rules: it is off outside
        ``aep``; it needs ``dist_data`` (whose plan dropped the hot
        vertices from the push contract), and is off when the plan found
        no hot set; a budget that cannot refresh the busiest owner's hot
        vertices within a life-span draws a warning."""
        cfg, dev, R = self.cfg, self.device, self.num_ranks
        model = build_model(cfg, seed=seed, device=dev, params=params)
        dims = layer_dims(cfg)
        hec = [[hec_lib.hec_init(cfg.hec.cache_size, cfg.hec.ways, dims[l],
                                 dev) for _ in range(R)]
               for l in range(cfg.num_layers)]
        hot = []
        eng = self.engine
        if eng.hot_budget and self.mode != "aep":
            eng.hot_budget = 0             # the tier is an AEP mechanism
        elif eng.hot_budget:
            if dist_data is None:
                raise ValueError(
                    "hec.hot_size/hot_budget are enabled: init_state needs "
                    "dist_data (build_dist_data(ps, cfg, device)) so the "
                    "tier replicas match the plan's hot tables")
            if "hot_vids" not in dist_data:
                eng.hot_budget = 0         # no hot set, contract unfiltered
            else:
                K = dist_data["hot_vids"].shape[1]
                owned_max = int(dist_data["hot_mine"].sum(1).max())
                refresh = cfg.hec.hot_budget * cfg.hec.life_span
                if refresh < owned_max:
                    warnings.warn(
                        f"hot tier refresh budget is undersized: the "
                        f"busiest rank owns {owned_max} of {K} hot "
                        f"vertices but can refresh only hot_budget*"
                        f"life_span = {refresh} per staleness window; "
                        f"unrefreshed replicas go stale and those hub "
                        f"halos degrade like HEC misses (dropped from "
                        f"aggregation)")
                hot = [hot_lib.tier_init(K, dims[l], dev, num_ranks=R)
                       for l in range(cfg.num_layers)]
        return {"model": model, "opt": opt_lib.adam_init(
                    model.parameter_list()),
                "hec": hec, "hot": hot,
                "inflight": eng.inflight_init(max(dims), dev),
                "step": 0}

    # -- the forward ---------------------------------------------------------
    def _inputs(self, data: dict, mb: dict) -> List[RankInputs]:
        """Every rank's layer-0 input: its own features, halo rows zero
        and invalid; in ``sync`` mode the halo fetch then fills the first
        ``nc`` halo rows of every rank from their owners."""
        R = self.num_ranks
        num_solid = data["num_solid"][:, None]
        vid_o, feats = data["vid_o"], data["features"]
        nodes, masks = mb["layer_nodes"], mb["node_mask"]
        vid_o_nodes = [torch.where(n >= 0, vid_o.gather(
            1, n.clamp(0, vid_o.shape[1] - 1).long()), -1) for n in nodes]
        is_halo0 = (nodes[0] >= num_solid) & masks[0]
        valid0 = masks[0] & ~is_halo0
        rows = torch.arange(R, device=feats.device)[:, None]
        h0 = feats[rows, nodes[0].clamp(0, feats.shape[1] - 1).long()] \
            * valid0[..., None].float()
        got = None
        if self.mode == "sync":
            h0, got = self.engine.sync_fetch(
                data["solid_sorted_vids"], data["solid_sorted_idx"], feats,
                vid_o_nodes[0], is_halo0, h0)
        return [RankInputs(nodes=[n[r] for n in nodes],
                           masks=[m[r] for m in masks],
                           vid_o_nodes=[v[r] for v in vid_o_nodes],
                           is_halo0=is_halo0[r], h0=h0[r], valid0=valid0[r],
                           got=None if got is None else got[r])
                for r in range(R)]

    def _substitute(self, hec, hot, hot_vids, r, k, h, valid, is_halo,
                    vids):
        """``aep`` at layer k of rank r: halo rows fresh in the hot tier's
        replica take it, the others HEC hits; returns the new ``(h,
        valid)`` and the (locally served, halo, hot) row counts."""
        use_hot = None
        if hot:
            t_hit, t_emb = hot_lib.tier_lookup(hot[k].rank(r), hot_vids,
                                               vids, self.cfg.hec.life_span)
            use_hot = is_halo & t_hit
            h = torch.where(use_hot[:, None], t_emb[:, :h.shape[1]], h)
        hit, emb = hec_lib.hec_lookup(hec[k][r], vids)
        use = is_halo & hit
        if use_hot is not None:
            use = use & ~use_hot
        h = torch.where(use[:, None], emb[:, :h.shape[1]], h)
        valid = (valid & ~is_halo) | use
        if use_hot is None:
            return h, valid, (use.sum(), is_halo.sum(), None)
        served = use | use_hot
        return h, valid | use_hot, (served.sum(), is_halo.sum(),
                                    use_hot.sum())

    def _rank_forward(self, model, hec, hot, data: dict, mb: dict,
                      x: RankInputs, r: int, seed: int, dropout: float,
                      poison: bool = False) -> RankForward:
        L = self.cfg.num_layers
        num_solid = data["num_solid"][r]
        hot_vids = data["hot_vids"][r] if hot else None
        aep = self.mode == "aep"
        h0, valid0, is_halo0 = x.h0, x.valid0, x.is_halo0
        if aep:
            h0, valid0, hit0 = self._substitute(
                hec, hot, hot_vids, r, 0, h0, valid0, is_halo0,
                x.vid_o_nodes[0])
        elif self.mode == "sync":                 # the fetched rows
            valid0 = valid0 | x.got
            hit0 = (x.got.sum(), is_halo0.sum(), None)
        else:                                     # drop
            hit0 = (torch.zeros_like(is_halo0.sum()), is_halo0.sum(), None)
        if poison:
            # the nan_step fault: after every substitution, so the whole
            # forward and backward go non-finite and the guard must skip
            h0 = h0 * float("nan")
        hits = [hit0]
        captured = {}

        def halo_hook(k, h, valid):
            if k == 0:
                captured[0] = (h, valid)
                return h, valid
            is_halo = (x.nodes[k] >= num_solid) & x.masks[k]
            if aep:
                h, valid, hit = self._substitute(hec, hot, hot_vids, r, k, h,
                                                 valid, is_halo,
                                                 x.vid_o_nodes[k])
                hits.append(hit)
            else:
                valid = valid & ~is_halo
            captured[k] = (h.detach(), valid)
            return h, valid

        out, valid = model.train_forward(
            h0, valid0, {"nbr_idx": [n[r] for n in mb["nbr_idx"]]},
            dropout=dropout, seed=seed, halo_hook=halo_hook)
        B = mb["seeds"].shape[1]
        logits = out[:B]
        lmask = mb["seed_mask"][r] & valid[:B]
        labels = mb["labels"][r].long()
        logz = torch.logsumexp(logits, -1)
        gold = logits.gather(1, labels[:, None])[:, 0]
        nll = (logz - gold) * lmask.float()
        n_valid = lmask.sum()
        nll_sum = nll.sum()
        correct = ((logits.argmax(-1) == labels) & lmask).sum()
        return RankForward(
            loss=nll_sum / n_valid.clamp_min(1), nll_sum=nll_sum.detach(),
            correct=correct, n_valid=n_valid,
            captured=[captured[l] for l in range(L)],
            hits=hits, nodes0=x.nodes[0], mask0=x.masks[0],
            vid0=x.vid_o_nodes[0])

    def _forward(self, state: dict, data: dict, mb: dict, seed: int,
                 dropout: float, codes=None) -> List[RankForward]:
        """Every rank's forward; ``codes`` (host ints per rank, armed
        steps only) poison a ``nan_step`` rank's layer-0 input."""
        xs = self._inputs(data, mb)
        return [self._rank_forward(
                    state["model"], state["hec"], state["hot"], data, mb, x,
                    r, seed, dropout,
                    codes is not None and bool(codes[r] & CODE_NAN_STEP))
                for r, x in enumerate(xs)]

    def _consume(self, state: dict, undo: Optional[list] = None):
        """``aep``: every rank ticks its HECs (and tier replica) and stores
        its queue's slot 0 (``undo``: journal of the overwritten rows)."""
        dims = layer_dims(self.cfg)
        for r in range(self.num_ranks):
            self.engine.consume_push(
                [layer[r] for layer in state["hec"]], state["inflight"][r],
                dims, self.cfg.hec.life_span,
                hot=[t.rank(r) for t in state["hot"]] or None, undo=undo)

    def _select(self, state: dict, data: dict, f: RankForward, r: int,
                seed: int, codes=None):
        """Rank r's push selection and, with the hot tier, its broadcast
        segment (the selection uniforms drawn here); on an armed step
        (``codes``) its non-finite rows dropped and its wire fault
        applied (``HaloExchangeEngine.filter_push``)."""
        R, dims = self.num_ranks, layer_dims(self.cfg)
        n0 = f.nodes0.shape[0]
        args = (f.nodes0, f.mask0, f.vid0, data["num_solid"][r], f.captured)
        sel = self.engine.select_push(
            data["push_mask"][r], *args,
            self.push_uniforms(seed, r, (R, n0)), dims, max(dims))
        hot = None if not state["hot"] else self.engine.select_hot_push(
            data["hot_vids"][r], data["hot_mine"][r], *args,
            self.hot_uniforms(seed, r, (n0,)), dims, max(dims))
        if codes is not None:
            sel, hot = self.engine.filter_push(sel, hot, int(codes[r]))
        return sel, hot

    def _send(self, state: dict, sels: list) -> dict:
        """Every rank's selection (and hot segment) in one fused
        all_to_all into the queues; returns the push stats."""
        hot = [h for _, h in sels] if state["hot"] else None
        state["inflight"], stats = self.engine.aep_push(
            [s for s, _ in sels], state["inflight"], layer_dims(self.cfg),
            hot=hot)
        return stats

    def _push(self, state: dict, data: dict, fwd: List[RankForward],
              seed: int, codes=None) -> dict:
        """The whole push, inline on the current stream."""
        return self._send(state, [self._select(state, data, f, r, seed,
                                               codes)
                                  for r, f in enumerate(fwd)])

    def _side(self):
        """The push's stream context (none off the side stream)."""
        return (torch.cuda.stream(self.push_stream)
                if self.push_stream is not None
                else contextlib.nullcontext())

    def _side_begin(self, state: dict, fwd: List[RankForward]):
        """Before the push on ``push_stream``: what it reads from the main
        stream is recorded on the push stream (so the caching allocator
        reuses no block it may still read), and the push stream waits
        for the forward's kernels."""
        side = self.push_stream
        read = [t for f in fwd for t in (f.nodes0, f.mask0, f.vid0)]
        read += [t for f in fwd for pair in f.captured for t in pair]
        read += [t for q in state["inflight"] for t in q.values()]
        for t in read:
            t.record_stream(side)
        side.wait_stream(torch.cuda.current_stream(self.device))

    def _side_end(self, state: dict, stats: dict):
        """After the push: what it leaves for the main stream (the queues,
        the stats) is recorded on it, and the push's event is kept for
        its readers (:meth:`join_push`)."""
        main = torch.cuda.current_stream(self.device)
        for t in ([t for q in state["inflight"] for t in q.values()]
                  + list(stats.values())):
            t.record_stream(main)
        self._pushed = self.push_stream.record_event()

    def join_push(self):
        """Make the current stream wait for the last push (a no-op off
        the side stream)."""
        if self._pushed is not None:
            torch.cuda.current_stream(self.device).wait_event(self._pushed)

    # -- the step ------------------------------------------------------------
    @property
    def step_armed(self) -> bool:
        """The resilience plane arms the step (fault codes, the guard)."""
        return self.resilience is not None and self.resilience.step_armed

    def train_step(self, state: dict, data: dict, mb: dict, seed: int,
                   codes: Optional[Sequence[int]] = None) -> dict:
        """One synchronized step of every rank on the device minibatch
        ``mb`` with the u32 ``seed``; updates ``state`` in place and
        returns the step's metrics (floats), with the reference's keys
        for the mode.  On a step-armed trainer ``codes`` are the ranks'
        fault codes (default all 0) and the metrics gain ``skipped``."""
        cfg, L = self.cfg, self.cfg.num_layers
        aep = self.mode == "aep"
        model, hec = state["model"], state["hec"]
        armed = self.step_armed
        if not armed and codes is not None:
            raise ValueError("fault codes need a step-armed resilience "
                             "plane (nan_guard or a fault schedule)")
        if armed and codes is None:
            codes = np.zeros(self.num_ranks, np.int32)
        if aep:
            self.join_push()
            self._consume(state)
        fwd = self._forward(state, data, mb, seed, cfg.dropout, codes)
        params = model.parameter_list()
        push = None
        if aep and self.overlap:
            # the push reads only forward activations: each rank's
            # selection is dispatched before that rank's backward, so on
            # the card the push stream's kernels run beside the backward's
            # (the host dispatches both; the backward's larger kernels
            # keep the main stream busy while the next rank's selection
            # is launched), then the fused all_to_all
            if self.push_stream is not None:
                self._side_begin(state, fwd)
            sels, rank_grads = [], []
            for r, f in enumerate(fwd):
                with self._side():
                    sels.append(self._select(state, data, f, r, seed,
                                             codes))
                rank_grads.append(torch.autograd.grad(f.loss, params))
            with self._side():
                push = self._send(state, sels)
            if self.push_stream is not None:
                self._side_end(state, push)
        else:
            rank_grads = [torch.autograd.grad(f.loss, params) for f in fwd]
        # example-weighted all-reduce: the gradient of the global batch mean
        n_valid = torch.stack([f.n_valid for f in fwd])
        examples = self.comm.psum(n_valid)
        weight = n_valid.float()
        denom_f = examples.float().clamp_min(1.0)
        grads = [self.comm.psum(torch.stack(
                     [g[i] * weight[r] for r, g in enumerate(rank_grads)]))
                 / denom_f for i in range(len(params))]
        denom = examples.clamp_min(1)
        loss_m = self.comm.psum(torch.stack([f.nll_sum for f in fwd])) / denom
        acc_m = self.comm.psum(torch.stack([f.correct for f in fwd])) / denom
        opt = state["opt"]
        if armed:
            # the guard's fallback: the parameters and moments as they are
            with torch.no_grad():
                kept = [t.clone() for t in list(params) + opt.mu + opt.nu]
        diag = opt_lib.adam_update(
            grads, opt, params, opt_lib.AdamConfig(lr=cfg.lr, grad_clip=1.0))
        grad_norm = diag["grad_norm"]
        if armed:
            # the NaN/Inf step guard: loss and gradients are already
            # summed over the ranks, so every rank takes the same branch;
            # a device select, no host sync (a clean step selects the new
            # bits everywhere)
            ok = torch.isfinite(loss_m)
            for g in grads:
                ok = ok & torch.isfinite(g).all()
            with torch.no_grad():
                for t, old in zip(list(params) + opt.mu + opt.nu, kept):
                    t.copy_(torch.where(ok, t, old))
            zero = torch.zeros((), device=loss_m.device)
            loss_m = torch.where(ok, loss_m, zero)
            acc_m = torch.where(ok, acc_m, zero)
            examples = torch.where(ok, examples, torch.zeros_like(examples))
            grad_norm = torch.where(ok, grad_norm, zero)
        state["step"] += 1
        if aep and not self.overlap:       # the legacy inline schedule
            push = self._push(state, data, fwd, seed, codes)
        metrics = {"loss": loss_m, "acc": acc_m, "examples": examples,
                   "grad_norm": grad_norm}
        if armed:
            metrics["skipped"] = 1.0 - ok.float()
        if push is not None:
            self.join_push()
            metrics["aep_push_rows"] = self.comm.psum(push["push_rows"])
            metrics["aep_push_bytes"] = self.comm.psum(push["push_bytes"])
            if "hot_push_rows" in push:
                metrics["hot_push_rows"] = self.comm.psum(
                    push["hot_push_rows"])
        psum = lambda xs: self.comm.psum(torch.stack(xs))  # noqa: E731
        for l in range(len(fwd[0].hits)):
            metrics[f"hec_hits_l{l}"] = psum([f.hits[l][0] for f in fwd])
            metrics[f"hec_halos_l{l}"] = psum([f.hits[l][1] for f in fwd])
            if state["hot"]:
                metrics[f"hot_hits_l{l}"] = psum([f.hits[l][2] for f in fwd])
        occ = [(st.tags >= 0).float().mean() for layer in hec for st in layer]
        stats = self._rank_stats(mb, fwd, push, bool(state["hot"]))
        # ONE device-to-host copy of the metrics, the occupancies and the
        # per-rank series (float64 holds every value exactly)
        parts = list(metrics.values()) + occ + list(stats.values())
        host = torch.cat([t.reshape(-1).double() for t in parts]).cpu()
        vals = host.tolist()
        out = dict(zip(metrics, vals))
        if out.get("skipped"):
            # Adam's count is a host int: a skipped step does not advance
            # it (the reference's guard selects back opt_state["step"])
            opt.step -= 1
        i = len(metrics)
        R = self.num_ranks
        for l in range(L):
            out[f"hec_occ_l{l}"] = float(np.mean(vals[i:i + R]))
            i += R
        self.rank_stats = {}
        for k in stats:
            self.rank_stats[k] = host[i:i + R].numpy()
            i += R
        return out

    def _rank_stats(self, mb: dict, fwd: List[RankForward],
                    push: Optional[dict], hot: bool) -> dict:
        """The step's per-rank series before the sum over ranks (the
        reference's ``rank_stats``), each ``[R]`` float32 on the device."""
        stack = lambda xs: torch.stack(xs).float()  # noqa: E731
        stats = {
            "rank_examples": stack([f.n_valid for f in fwd]),
            "rank_sample_rows": sum(m.sum(1) for m in mb["node_mask"])
            .float(),
            "rank_halo_rows": stack([sum(h[1] for h in f.hits) for f in fwd]),
            "rank_hec_hits": stack([sum(h[0] for h in f.hits) for f in fwd]),
        }
        if hot:
            stats["rank_hot_hits"] = stack([sum(h[2] for h in f.hits)
                                            for f in fwd])
        if push is not None:
            stats["rank_push_rows"] = push["push_rows"].float()
            stats["rank_push_bytes"] = push["push_bytes"].float()
        return stats

    # -- epochs ------------------------------------------------------------
    def _resolve_pipeline(self, ps: PartitionSet, seed0: int, pipeline):
        """``"auto"``: a :class:`MinibatchPipeline` iff
        ``cfg.pipeline.enabled``, else ``None``; anything else as given."""
        if pipeline != "auto":
            return pipeline
        if not self.cfg.pipeline.enabled:
            return None
        rz = self.resilience
        return MinibatchPipeline(ps, self.cfg, base_seed=seed0,
                                 device=self.device,
                                 injector=rz.injector if rz else None)

    def train_epochs(self, ps: PartitionSet, data: dict, state: dict,
                     num_epochs: int, seed0: int = 0, log_every: int = 0,
                     pipeline="auto", start_epoch: int = 0):
        """Train ``num_epochs`` epochs, ``start_epoch`` onward.
        ``pipeline``: ``"auto"`` (a :class:`MinibatchPipeline` with
        ``base_seed=seed0`` when ``cfg.pipeline.enabled``, else
        unstaged), a ``MinibatchPipeline`` as given, or ``None``: the
        reference's unstaged path, ``gnn_epoch_iterator`` with one
        ``np.random.default_rng(seed0)`` across the epochs, each batch
        copied in step order.  Every pipelined minibatch is a pure
        function of ``(seed0, epoch, step)``, so ``start_epoch=k`` replays
        epoch k's batches: restoring the checkpoint written after epoch
        k-1 and going on from k gives the uninterrupted run's bits.  With
        ``resilience``, each step takes its fault codes (step-armed), a
        checkpoint is written at the epoch boundaries it asks for, and
        ``FLIGHT_resilience.json`` at the end if a fault fired or a step
        was skipped.  Returns ``(state, history)``: per epoch the
        metrics' means, the fanout draw's ``sampler_policy`` and, while
        the registry is on, the host seconds of the ``sample``,
        ``host_prep``, ``stage`` and ``step`` spans (``t_<span>``) and of
        the epoch (``t_wall``)."""
        cfg = self.cfg
        pipeline = self._resolve_pipeline(ps, seed0, pipeline)
        rng = np.random.default_rng(seed0)
        reg = obs.get().registry
        phases = obs.MEASURED_PHASES
        s_policy = cfg.pipeline.sampler.policy
        health = self.health \
            if self.health is not None and self.health.enabled else None
        quality = self.quality \
            if self.quality is not None and self.quality.enabled else None
        acc = obs.RankAccumulator(self.num_ranks) \
            if reg.enabled or health else None
        guard = health.guard("train_step_loop") if health \
            else contextlib.nullcontext()
        history = []
        with guard:
            for ep in range(start_epoch, start_epoch + num_epochs):
                history.append(self._epoch(ps, data, state, ep, pipeline,
                                           rng, reg, phases, s_policy, acc,
                                           health, quality))
                mean = history[-1]
                if self.resilience is not None \
                        and self.resilience.ckpt is not None:
                    # the whole state (state["step"] is current): the
                    # push may still be writing the queues on its stream
                    self.join_push()
                    self.resilience.maybe_checkpoint(state, ep)
                if log_every and (ep % log_every == 0
                                  or ep == start_epoch + num_epochs - 1):
                    hl = " ".join(
                        f"l{l}:{mean.get(f'hec_hits_l{l}', 0) / max(mean.get(f'hec_halos_l{l}', 1), 1):.2f}"  # noqa: E501
                        for l in range(cfg.num_layers))
                    print(f"[{self.mode}] epoch {ep}: "
                          f"loss={mean['loss']:.4f} acc={mean['acc']:.3f} "
                          f"hit-rates {hl}")
        if self.resilience is not None:
            self.resilience.finalize(health)
        return state, history

    def _epoch(self, ps, data, state, ep, pipeline, rng, reg, phases,
               s_policy, acc, health, quality) -> dict:
        """One epoch of :meth:`train_epochs`; returns its history row."""
        cfg = self.cfg
        if (pipeline is not None and s_policy == "cv"
                and cfg.pipeline.sampler.device_draw):
            # control-variate sampling: the draw's weights prefer
            # vertices with a live line in the HEC as it is now
            pipeline.set_cv_residency(self._cv_residency(ps, state))
        if pipeline is not None:
            mb_iter = pipeline.epoch_batches(ep)
        else:
            from repro_torch.train.data import gnn_epoch_iterator
            mb_iter = self._unstaged(
                host for host, _ in gnn_epoch_iterator(ps, cfg, rng))
        ep_metrics = []
        ph0 = {p: reg.value("phase_seconds", phase=p) for p in phases}
        wall0 = time.perf_counter()
        t_step = 0.0
        rz = self.resilience if self.step_armed else None
        for k_ep, mb in enumerate(mb_iter):
            ts0 = time.perf_counter()
            # the step's fault codes by (epoch, step in the epoch); a
            # delay_rank fault sleeps in step_codes
            codes = (rz.step_codes(ep, k_ep, self.num_ranks),) if rz else ()
            with obs.span("step", epoch=ep, step=state["step"]):
                m = self.train_step(state, data, mb, state["step"], *codes)
            t_step += time.perf_counter() - ts0
            if rz:
                rz.on_step(ep, k_ep, m.get("skipped", 0.0))
            ep_metrics.append(m)
            self.step_log.append(m)
            if acc is not None:
                acc.add(self.rank_stats)
        mean = _epoch_mean(ep_metrics)
        mean["sampler_policy"] = s_policy
        wall = time.perf_counter() - wall0
        if reg.enabled:
            reg.counter("train_epochs_total", sampler_policy=s_policy).inc()
            for p in phases:
                mean[f"t_{p}"] = reg.value("phase_seconds", phase=p) - ph0[p]
            mean["t_wall"] = wall
        if acc is not None:
            totals = acc.finish()
            # R ranks in one process share one clock: each is credited
            # the epoch's step time (a multi-process run feeds its own)
            totals["rank_step_seconds"] = np.full(self.num_ranks, t_step,
                                                  np.float64)
            if reg.enabled:
                obs.publish_rank_series(reg, totals)
            if health:
                health.observe_epoch(totals, wall_s=wall)
        if quality:
            # staleness off the live caches and the convergence point;
            # the audit (an offline forward pass) on its interval only
            self.join_push()
            quality.observe_epoch(ep, metrics=mean)
            quality.publish_staleness(state["hec"])
            if state["hot"]:
                hot_lib.publish_replica_ages(state["hot"],
                                             life_span=cfg.hec.life_span)
            if quality.should_audit(ep):
                self.audit(ps, data, state, epoch=ep)
        return mean

    def _unstaged(self, hosts):
        """Host minibatches copied to the device one by one, in step
        order (the ``stage`` span)."""
        for host in hosts:
            with obs.span("stage"):
                mb = minibatch_to_device(host, self.device)
            yield mb

    def _cv_residency(self, ps: PartitionSet, state: dict) -> List[np.ndarray]:
        """Per rank a bool mask over VID_p: the vertices with a live line
        in any layer's HEC of that rank (tags hold VID_o); the reference's
        ``_cv_residency``, one host read of the tags per epoch."""
        self.join_push()
        V = sum(p.num_solid for p in ps.parts)
        masks = []
        for r, p in enumerate(ps.parts):
            res_o = np.zeros(V, bool)
            for layer in state["hec"]:
                tags = layer[r].tags.cpu().numpy()
                t = tags[tags >= 0]
                res_o[t[t < V]] = True
            masks.append(res_o[np.clip(p.vid_p_to_o(), 0, V - 1)])
        return masks

    @torch.no_grad()
    def audit(self, ps: PartitionSet, data: Optional[dict], state: dict,
              epoch: int = 0):
        """The online exactness audit (``quality`` needed): sample cached
        lines of each layer's HECs (every rank's, rank by rank) and the
        fresh hot-tier replicas, recompute their exact ``h^l`` by the
        sharded offline inference (``layerwise_embeddings_dist``: kernel A
        for GraphSAGE, G for GAT, on the trainer's own model), and publish
        the relative L2 error.  ``HEC_0`` holds raw features (exact at any
        age); hidden layers hold minibatch activations with the live
        dropout, so even a fresh line carries the sampling error against
        full-graph inference.  Reads the training state, never writes it;
        the sampling draws from the plane's own generator."""
        q = self.quality
        if q is None:
            raise ValueError("audit needs DistTrainer(quality=...)")
        cfg = self.cfg
        self.join_push()
        V = len(ps.owner)
        feats = np.zeros((V, cfg.feat_dim), np.float32)
        for p in ps.parts:
            feats[p.solid_vids] = np.asarray(p.features, np.float32)
        exact = [torch.as_tensor(feats)]
        if cfg.num_layers > 1:
            from repro_torch.serve.gnn.distributed.offline import \
                layerwise_embeddings_dist
            exact += layerwise_embeddings_dist(
                cfg, state["model"], ps)[:cfg.num_layers - 1]

        def rows(l, vids):
            idx = torch.as_tensor(vids, dtype=torch.long,
                                  device=exact[l].device)
            return exact[l].index_select(0, idx).cpu().numpy()
        layer_samples = []
        for l in range(cfg.num_layers):
            vids, cached, ages = hec_lib.hec_entries(
                state["hec"][l], sample=q.cfg.audit_samples, rng=q.rng)
            layer_samples.append((l, cached, rows(l, vids), ages))
        hot_samples = None
        if state["hot"] and data is not None and "hot_vids" in data:
            hv = data["hot_vids"][0].cpu().numpy()   # every rank's the same
            hot_samples = []
            for l, st in enumerate(state["hot"]):
                vids, vals, _ = hot_lib.tier_entries(
                    st, hv, life_span=cfg.hec.life_span)
                if len(vids):
                    width = exact[l].shape[1]
                    hot_samples.append((vals[:, :width], rows(l, vids)))
        return q.run_audit(epoch, layer_samples, hot_samples=hot_samples,
                           source="train")

    @torch.no_grad()
    def evaluate(self, ps: PartitionSet, data: dict, state: dict,
                 num_batches: int = 8, seed0: int = 123,
                 pipeline="auto") -> float:
        """Test accuracy over sampled test-vertex minibatches, dropout
        off, on the mode's own path: the pipeline's eval stream
        (``pipeline`` as in :meth:`train_epochs`, ``base_seed=seed0``),
        or with ``None`` the reference's unstaged one (each batch's test
        vertices shuffled by one ``np.random.default_rng(seed0)``, then
        ``sample_step``).  Each batch starts from the training state as
        it is: in ``aep`` one tick + consume of the in-flight queue, then
        the forward.  The consume is the only write, so the HEC tags and
        ages and the tier's ages are kept, the value rows it overwrites
        journaled, and all of it put back after the batch: the training
        state is left as it was, and no HEC is copied whole."""
        cfg = self.cfg
        pipeline = self._resolve_pipeline(ps, seed0, pipeline)
        if pipeline is not None:
            mb_iter = pipeline.eval_batches(num_batches, seed=seed0)
        else:
            rng = np.random.default_rng(seed0)

            def unstaged():
                for _ in range(num_batches):
                    seeds = []
                    for part in ps.parts:
                        test = np.flatnonzero(part.test_mask)
                        rng.shuffle(test)
                        seeds.append(test[:cfg.batch_size])
                    yield sample_step(ps, cfg, seeds, rng)
            mb_iter = self._unstaged(unstaged())
        aep = self.mode == "aep"
        self.join_push()
        kept = [(st.tags.clone(), st.age.clone())
                for layer in state["hec"] for st in layer] if aep else []
        kept_hot = [t.age.clone() for t in state["hot"]]
        undo = []
        accs, weights = [], []
        for k, mb in enumerate(mb_iter):
            if aep:
                self._consume(state, undo=undo)
            fwd = self._forward(state, data, mb, 10_000 + k, 0.0)
            if aep:
                hec_lib.undo_stores(undo)
                states = [st for layer in state["hec"] for st in layer]
                for st, (tags, age) in zip(states, kept):
                    st.tags.copy_(tags)
                    st.age.copy_(age)
                for t, age in zip(state["hot"], kept_hot):
                    t.age.copy_(age)
            examples = int(sum(int(f.n_valid) for f in fwd))
            correct = int(sum(int(f.correct) for f in fwd))
            accs.append(correct / max(examples, 1))
            weights.append(float(examples))
            del fwd
        if not sum(weights):
            return 0.0
        return float(np.average(accs, weights=weights))
