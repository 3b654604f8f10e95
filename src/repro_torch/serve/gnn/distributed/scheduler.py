"""Sharded multi-rank GNN serving, R ranks in one process on one card —
counterpart of ``repro/serve/gnn/distributed/scheduler.py`` (GraphSAGE or
GAT).

The graph is partitioned across R ranks; each shard holds its partition's
CSR, features and per-layer cache, and one serve round answers a
synchronized set of per-rank fixed-slot microbatches.  Per round:

  1. **routing** (host): the ``QueryRouter`` maps each queried VID_o to its
     owner and packs up to ``num_slots`` seeds per rank and segment,
  2. **cache-aware partition-local sampling** (host, per rank): the
     vectorized sampler with this shard's ``expandable`` masks, so
     cache-resident vertices (solids and halos) become leaves,
  3. **the step** (device): per layer the model's serve layer on every
     rank (GraphSAGE: one fused serve-layer launch, kernel A; GAT: the
     projection and one GAT AGG launch, kernel G).  Layer-0 halo rows read
     the shard's static **feature mirror**.  At every hidden layer each
     rank consults its local shard cache first (one HEC probe + load
     launch, kernel B), then the hot tier, and the remaining cross-cut
     halo rows are gathered from their owners' caches with ONE
     request/response all_to_all pair over the stacked collective
     (``HaloExchangeEngine.cache_fetch``, whose responder side is ONE
     launch of the batched probe, kernel J, for every rank).  Fetched
     rows are stored back into the local shard cache,
  4. **residency sync** (host): the outputs, the round's counters, every
     shard's tags and every replica's ages come back in ONE device-to-host
     copy, from which the residency mirrors are rebuilt.

A halo row whose owner cannot answer (cold owner cache, or more misses
than ``halo_slots``) is dropped from aggregation by the validity mask.
``update_params`` installs a new model and drops every cached line on
every shard and every hot-tier replica at once.

The three heavy-tail knobs of the reference, all off by default:
``hot_size=K`` (the plan's top-K hubs replicated on every shard,
``repro_torch.cache.hot_tier``), ``dedup=True`` (queries for one vertex
pending together share one compute slot) and ``round_batch=N`` (N rounds
fused block-diagonally into one step by ``concat_blocks``, so each hidden
layer's fetch is one collective pair with pooled budgets).

Not carried over: the reference's ``fused_kernel`` and ``probe_kernel``
switches — on the card the forward always runs A or G and the responder
always runs J, as the single-rank port always runs A.

Degraded-mode serving, as the reference's (``failover=True``): a per-rank
circuit breaker (``resilience.RankHealthMask``).  A rank marked dead
(``mark_dead``, or ``record_rank_failure`` reaching
``breaker_threshold``) has its queued and pending queries answered at
once from stale replicas (``_answer_degraded``: an alive shard's output
cache, read by kernel B, else an alive hot-tier replica, else zeros as
``degraded_dropped``), and each round's ``cache_fetch`` gets the
breaker's ``alive`` mask, so no request goes to the dead rank and it
answers none (kernel J masks it).  Every pump round ticks the breakers:
after ``breaker_cooldown`` rounds a rank gets one re-probe (``probe_fn``
in a side thread with ``probe_timeout_s``; ``None`` passes), which closes
the breaker or opens it again.  With every rank alive the answers are
failover-off's bits.

The planes, as the reference's: every round's per-rank stats (already
on the host after the round's one copy) become rank-labeled series and
cluster views (``_record_rank_round``) and, with ``health=``, one window
of the health plane's detectors (load skew, SLO burn, hot-tier decay);
``quality=`` is read by :meth:`audit`, which samples every shard's
cached lines and the hot replicas and holds them against the sharded
offline embeddings (fresh shards audit to exactly 0.0).  Neither writes
the caches or the answers.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.cache import hec as hec_lib
from repro_torch.cache import hot_tier as hot_lib
from repro_torch.cache.hot_tier import HotTierCache
from repro_torch.comm.engine import HaloExchangeEngine
from repro_torch.comm.plan import _pad_stack, hot_set_tables
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graph.partition import PartitionSet
from repro_torch.pipeline.vectorized_sampler import (concat_blocks,
                                                     sample_blocks_vectorized,
                                                     stack_ranks)
from repro_torch.resilience.failover import RankHealthMask
from repro_torch.serve.gnn.distributed.router import QueryRouter
from repro_torch.serve.gnn.distributed.sharded_cache import \
    ShardedServingCache
from repro_torch.serve.gnn.embedding_cache import ServeCacheConfig
from repro_torch.serve.gnn.offline import serve_layer_dims
from repro_torch.serve.gnn.scheduler import GNNRequest, ServeFrontend


@dataclasses.dataclass(frozen=True)
class DistServeConfig:
    num_slots: int = 32            # seeds per rank per round segment
    halo_slots: int = 256          # all_to_all request slots per rank pair
    cache: ServeCacheConfig = dataclasses.field(
        default_factory=ServeCacheConfig)
    sample_seed: int = 0           # base seed of the per-round RNG
    max_queue_depth: Optional[int] = None  # admission cap across all shards
    hot_size: int = 0              # K: replicated hot-tier slots (0 = off)
    dedup: bool = False            # cross-query neighborhood dedup
    round_batch: int = 1           # rounds fused into one step/collective
    failover: bool = False         # degraded-mode serving: per-rank health
    #                                mask + circuit breaker; a dead rank's
    #                                halo traffic is suppressed and its
    #                                queries answer from stale replicas
    #                                (all alive = failover off's bits)
    probe_timeout_s: float = 1.0   # re-probe timeout (a hung probe = dead)
    breaker_cooldown: int = 1      # rounds OPEN before the half-open probe
    breaker_threshold: int = 1     # failures that open a rank's breaker


def build_serve_data(ps: PartitionSet, device) -> dict:
    """Per-rank stacked serving tables on ``device``: features, the **halo
    feature mirror** (each shard's copy of its halos' input features:
    static, so layer 0 never travels), solid counts, VID_p -> VID_o and
    VID_p -> owner rank."""
    num_solid = np.array([p.num_solid for p in ps.parts], np.int32)
    feats = _pad_stack([p.features for p in ps.parts], 0.0)
    halo_feats = []
    for p in ps.parts:
        owner, local = ps.route(p.halo_vids) if p.num_halo else (
            np.empty(0, np.int64), np.empty(0, np.int64))
        hf = np.zeros((max(p.num_halo, 1), feats.shape[-1]), np.float32)
        for r in range(ps.num_parts):
            mine = owner == r
            hf[np.flatnonzero(mine)] = ps.parts[r].features[local[mine]]
        halo_feats.append(hf)
    vid_o = _pad_stack([p.vid_p_to_o().astype(np.int32) for p in ps.parts],
                       -1)
    owner_p = _pad_stack(
        [np.concatenate([np.full(p.num_solid, r, np.int32),
                         p.halo_owner.astype(np.int32)])
         for r, p in enumerate(ps.parts)], -1)
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    return {
        "features": t(feats, torch.float32),
        "halo_features": t(_pad_stack(halo_feats, 0.0), torch.float32),
        "num_solid": t(num_solid, torch.int64),
        "vid_o": t(vid_o, torch.int64),
        "owner_p": t(owner_p, torch.int64),
    }


def _host_copy(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Bring float32, integer and bool tensors to the host in ONE copy:
    packed as int32 (floats bitcast, counts narrowed), copied once, split
    and given back their types."""
    if not tensors:
        return []
    parts = [t.contiguous().view(torch.int32) if t.dtype == torch.float32
             else t.to(torch.int32) for t in tensors]
    flat = torch.cat([p.reshape(-1) for p in parts]).cpu().numpy()
    out, o = [], 0
    for t in tensors:
        a = flat[o:o + t.numel()].reshape(tuple(t.shape))
        o += t.numel()
        if t.dtype == torch.float32:
            a = a.view(np.float32)
        elif t.dtype == torch.bool:
            a = a.astype(bool)
        out.append(a)
    return out


class DistGNNServeScheduler(ServeFrontend):
    """Sharded serving over a ``PartitionSet``, the ranks stacked on one
    device (``None``: the card; raises without one)."""

    def __init__(self, cfg, model, ps: PartitionSet,
                 serve_cfg: Optional[DistServeConfig] = None,
                 device: DeviceLike = None,
                 health: Optional["obs.HealthPlane"] = None,
                 quality: Optional["obs.QualityPlane"] = None):
        self.scfg = serve_cfg or DistServeConfig()
        self.health = health \
            if health is not None and health.enabled else None
        self.quality = quality \
            if quality is not None and quality.enabled else None
        self.device = resolve_device(device)
        self.cfg = cfg
        self.ps = ps
        self.num_ranks = ps.num_parts
        self.model = model.to(self.device)
        self.data = build_serve_data(ps, self.device)
        dims = serve_layer_dims(cfg)
        self.cache = ShardedServingCache(dims, ps, self.scfg.cache,
                                         device=self.device)
        self.router = QueryRouter(ps)
        self.engine = HaloExchangeEngine(self.num_ranks, cfg.num_layers,
                                         push_limit=self.scfg.halo_slots)
        # replicated hot tier over the static hot set (hubs that are halos
        # somewhere); needs the cache on
        self.hot: Optional[HotTierCache] = None
        if self.scfg.hot_size and self.scfg.cache.enabled:
            hot_vids, _, _ = hot_set_tables(ps, self.scfg.hot_size)
            if len(hot_vids):
                self.hot = HotTierCache(dims, hot_vids, self.num_ranks,
                                        device=self.device)
                self._hot_vid_p = self._hot_local_positions(hot_vids)
        self._init_frontend()
        # degraded-mode failover: the per-rank circuit breaker
        self.breaker: Optional[RankHealthMask] = None
        self.probe_fn = None   # Callable[[int], bool]; None = probe passes
        self.degraded_answers = 0
        self.degraded_dropped = 0
        if self.scfg.failover:
            self.breaker = RankHealthMask(
                self.num_ranks, cooldown=self.scfg.breaker_cooldown,
                threshold=self.scfg.breaker_threshold)

    def reset_frontend(self):
        """Zero the frontend counters, the fast-path lookup batches and
        the per-round log."""
        super().reset_frontend()
        self.fast_path_rounds = 0      # stacked fast-path lookup batches
        self.round_log: List[dict] = []

    def _hot_local_positions(self, hot_vids: np.ndarray) -> List[np.ndarray]:
        """Per shard, the VID_p of each hot vertex (solid or halo), or -1
        where it does not appear in that shard's partition."""
        out = []
        owner, local = self.ps.route(hot_vids)
        for r, p in enumerate(self.ps.parts):
            arr = np.full(len(hot_vids), -1, np.int64)
            mine = owner == r
            arr[mine] = local[mine]
            if p.num_halo:
                pos = np.clip(np.searchsorted(p.halo_vids, hot_vids), 0,
                              p.num_halo - 1)
                halo = (p.halo_vids[pos] == hot_vids) & ~mine
                arr[halo] = p.num_solid + pos[halo]
            out.append(arr)
        return out

    def _expandable(self, rank: int):
        """The shard's cache-residency leaf masks, with tier-valid hubs as
        leaves too (their layer-k embedding comes from the local
        replica)."""
        masks = self.cache.expandable_masks(rank)
        if self.hot is None:
            return masks
        hot_p = self._hot_vid_p[rank]
        for k in range(1, len(masks)):
            if masks[k] is None:
                continue
            sel = hot_p[(hot_p >= 0) & self.hot.valid[k - 1][rank]]
            if len(sel):
                masks[k] = masks[k].copy()
                masks[k][sel] = False
        return masks

    # -- the step (all ranks) -------------------------------------------------
    def _lookup(self, state: hec_lib.HECState, vids: torch.Tensor):
        """Every rank's own cache probed with its ``vids [R, m]``: one
        probe + load launch per rank -> (hit [R, m], emb [R, m, d])."""
        res = [hec_lib.hec_lookup(state.rank(r), vids[r])
               for r in range(self.num_ranks)]
        return (torch.stack([h for h, _ in res]),
                torch.stack([e for _, e in res]))

    def _tier_lookup(self, state: hot_lib.HotTierState, vids: torch.Tensor):
        res = [hot_lib.tier_lookup(state.rank(r), self.hot.hot_vids_t,
                                   vids[r]) for r in range(self.num_ranks)]
        return (torch.stack([h for h, _ in res]),
                torch.stack([e for _, e in res]))

    @torch.no_grad()
    def _step(self, states: List[hec_lib.HECState],
              tstates: List[hot_lib.HotTierState], mb: dict,
              alive: Optional[torch.Tensor] = None):
        """Forward of every rank with cached-embedding substitution and the
        halo fetch at each hidden layer, then the store-back.  ``alive``
        ([R] bool, failover): the fetch asks no dead owner and a dead
        responder answers nothing.  Returns (out [R, B, C], out_valid
        [R, B], stats of [R, ...] counters)."""
        L = self.cfg.num_layers
        R = self.num_ranks
        NB = self.scfg.round_batch
        data = self.data
        dev = self.device
        num_solid = data["num_solid"][:, None]
        ar = torch.arange(R, device=dev)[:, None]
        Pmax = data["vid_o"].shape[1]

        def lut(tab, n):
            return torch.where(n >= 0, tab[ar, n.long().clamp(0, Pmax - 1)],
                               -1)
        vid_o_nodes = [lut(data["vid_o"], n) for n in mb["layer_nodes"]]
        owner_nodes = [lut(data["owner_p"], n) for n in mb["layer_nodes"]]

        nodes0 = mb["layer_nodes"][0].long()
        mask0 = mb["node_mask"][0]
        is_halo0 = (nodes0 >= num_solid) & mask0
        Smax = data["features"].shape[1]
        Hmax = data["halo_features"].shape[1]
        # layer 0: solids read their own features, halos the static mirror
        h_sol = data["features"][ar, nodes0.clamp(0, Smax - 1)]
        h_hal = data["halo_features"][ar, (nodes0 - num_solid)
                                      .clamp(0, Hmax - 1)]
        h = torch.where(is_halo0[..., None], h_hal, h_sol) \
            * mask0[..., None]
        valid = mask0

        def tier_sub(k, h, maskk, already):
            """Local-replica substitution for hub rows the HEC missed."""
            if self.hot is None:
                return h, torch.zeros_like(maskk)
            t_hit, t_emb = self._tier_lookup(tstates[k - 1], vid_o_nodes[k])
            use = t_hit & maskk & ~already
            return torch.where(use[..., None], t_emb, h), use

        captured = {}
        hits, lookups, hot_hits = [], [], []
        halo_seen, halo_local, halo_fetched, halo_requested = [], [], [], []
        for k in range(L):
            nbr = mb["nbr_idx"][k]
            h = torch.stack([self.model.serve_layer(k, h[r], nbr[r],
                                                    valid[r])
                             for r in range(R)])
            valid = valid[:, :nbr.shape[1]]
            if k == L - 1:
                break
            k1 = k + 1
            vids = vid_o_nodes[k1]
            maskk = mb["node_mask"][k1]
            is_halo = (mb["layer_nodes"][k1] >= num_solid) & maskk
            # local shard cache first: cached solids AND cached halos
            hit, emb = self._lookup(states[k1 - 1], vids)
            hit = hit & maskk
            h = torch.where(hit[..., None], emb, h)
            # then the hot tier, then the owners' caches over the wire
            h, hot_hit = tier_sub(k1, h, maskk, hit)
            need = is_halo & ~hit & ~hot_hit
            h, got, nreq = self.engine.cache_fetch(
                states[k1 - 1], vids, owner_nodes[k1], need, h, rounds=NB,
                alive=alive)
            # a halo is valid only if substituted: its local partial
            # compute never aggregated its remote neighborhood
            valid = ((valid & ~is_halo) | hit | hot_hit | got) & maskk
            hits.append(hit.sum(1))
            lookups.append(maskk.sum(1))
            hot_hits.append((is_halo & hot_hit).sum(1))
            halo_seen.append(is_halo.sum(1))
            halo_local.append((is_halo & (hit | hot_hit)).sum(1))
            halo_fetched.append(got.sum(1))
            halo_requested.append(nreq)
            captured[k1] = (h, valid)

        seed_mask = mb["seed_mask"]
        B = seed_mask.shape[1]
        out = h[:, :B]
        hitL, embL = self._lookup(states[L - 1], vid_o_nodes[L])
        hitL = hitL & seed_mask
        out = torch.where(hitL[..., None], embL, out)
        out, hotL = tier_sub(L, out, seed_mask, hitL)
        out_valid = (valid[:, :B] | hitL | hotL) & seed_mask
        hits.append(hitL.sum(1))
        lookups.append(seed_mask.sum(1))

        # store-back after every lookup: computed and fetched layer-k rows
        # enter THIS shard's cache keyed by VID_o; hub rows also refresh
        # the local tier replica
        def put(k, h_k, valid_k):
            vids_k = vid_o_nodes[k]
            for r in range(R):
                hec_lib.hec_store(states[k - 1].rank(r),
                                  torch.where(valid_k[r], vids_k[r], -1),
                                  h_k[r])
                if self.hot is not None:
                    slot, is_hot = hot_lib.tier_slots(self.hot.hot_vids_t,
                                                      vids_k[r])
                    hot_lib.tier_store(tstates[k - 1].rank(r), torch.where(
                        valid_k[r] & is_hot, slot, -1), h_k[r])
        for k in range(1, L):
            put(k, *captured[k])
        put(L, out, out_valid)

        def stack(xs):
            return torch.stack(xs, 1) if xs else \
                torch.zeros((R, 0), dtype=torch.int64, device=dev)
        stats = {"hits": stack(hits), "lookups": stack(lookups),
                 "halo_l0": is_halo0.sum(1),        # mirror-served features
                 "halo_seen": stack(halo_seen),     # hidden layers only
                 "halo_local": stack(halo_local),
                 "halo_fetched": stack(halo_fetched),
                 "halo_requested": stack(halo_requested),
                 "hot_hits": stack(hot_hits)}
        return out, out_valid, stats

    # -- public API -----------------------------------------------------------
    def submit(self, vid: int) -> GNNRequest:
        req = self._admit(vid, len(self.router))
        self.router.enqueue(req)
        return req

    def pump(self) -> int:
        """Serve everything queued; returns the rounds run (each covers
        ``round_batch`` fused segments)."""
        R = self.num_ranks
        cap = self.scfg.num_slots * self.scfg.round_batch
        ran = 0
        # pending compute work as groups (local_vid, [requests]); with dedup
        # on, queries for one vertex share one group and one compute slot
        pending: List[List] = [[] for _ in range(R)]
        index: List[dict] = [dict() for _ in range(R)]
        while len(self.router) or any(pending):
            if self.breaker is not None:
                # tick the breakers (a rank past its cooldown gets its
                # re-probe), then answer a still-dead rank's queries from
                # stale replicas at once: a dead shard never stalls a round
                self._breaker_tick()
                for r in self.breaker.dead_ranks:
                    if self.router.queues[r]:
                        drained = self.router.drain(
                            r, len(self.router.queues[r]))
                        self._answer_degraded([e[0] for e in drained])
                    if pending[r]:
                        self._answer_degraded(
                            [q for _, reqs in pending[r] for q in reqs])
                        pending[r] = []
                        index[r].clear()
            # fill FULL per-rank microbatches with cache misses: output-
            # cache hits are answered by the fast path and take no slot
            fast: List[List] = [[] for _ in range(R)]
            for r in range(R):
                while self.router.queues[r] and len(pending[r]) < cap:
                    wave = self.router.drain(r, cap - len(pending[r]))
                    if self.scfg.cache.enabled:
                        hits, misses = self._split_fast_path(r, wave)
                        fast[r].extend(hits)
                    else:
                        misses = wave
                    self._absorb(pending[r], index[r], misses)
            for r, misses in enumerate(self._answer_fast_path(fast)):
                self._absorb(pending[r], index[r], misses)  # mirror stale
            if any(pending):
                take = [p[:cap] for p in pending]
                self._run_round(take)
                for r in range(R):
                    for local, _ in take[r]:
                        index[r].pop(local, None)
                    pending[r] = pending[r][cap:]
                ran += 1
        return ran

    def _absorb(self, groups: List, index: dict, entries):
        """Fold routed (request, local_vid) entries into pending groups;
        with dedup on, a repeat vid joins the existing group."""
        for req, local in entries:
            if self.scfg.dedup and local in index:
                index[local][1].append(req)
                self.dedup_merged += 1
            else:
                g = (local, [req])
                groups.append(g)
                if self.scfg.dedup:
                    index[local] = g

    def serve(self, vids: Sequence[int]) -> np.ndarray:
        """Submit ``vids``, pump, return outputs in order."""
        reqs = [self.submit(v) for v in vids]
        self.pump()
        return np.stack([r.result for r in reqs])

    def update_params(self, model) -> int:
        """Install a new model; every shard drops its cache and every
        hot-tier replica at once."""
        self.model = model.to(self.device)
        if self.hot is not None:
            self.hot.on_model_update()
        return self.cache.on_model_update()

    def metrics(self) -> dict:
        out = self.cache.metrics()
        out.update(self._frontend_metrics(len(self.router)))
        out["round_batch"] = self.scfg.round_batch
        out["fast_path_rounds"] = self.fast_path_rounds
        if self.hot is not None:
            out.update(self.hot.metrics())
        if self.breaker is not None:
            out["serve_degraded"] = float(self.breaker.any_dead)
            out["dead_ranks"] = list(self.breaker.dead_ranks)
            out["degraded_answers"] = self.degraded_answers
            out["degraded_dropped"] = self.degraded_dropped
        return out

    # -- degraded-mode failover ----------------------------------------------
    def mark_dead(self, rank: int) -> None:
        """Declare a rank dead (a failed liveness probe, a hung call): its
        breaker opens at once, halo traffic to and from it stops from the
        next round, and its queries answer from stale replicas until a
        re-probe passes."""
        if self.breaker is None:
            raise RuntimeError("mark_dead requires DistServeConfig"
                               "(failover=True)")
        self.breaker.force_open(rank, self.steps_run)
        self._rank_event("dead", rank)
        self._publish_mask()

    def record_rank_failure(self, rank: int) -> bool:
        """Count one failure against ``rank``; True when the failures
        reach ``breaker_threshold`` and the breaker opens (the rank is then
        treated as by ``mark_dead``)."""
        if self.breaker is None:
            raise RuntimeError("record_rank_failure requires "
                               "DistServeConfig(failover=True)")
        opened = self.breaker.record_failure(rank, self.steps_run)
        if opened:
            self._rank_event("dead", rank)
            self._publish_mask()
        return opened

    def _rank_event(self, what: str, rank: int) -> None:
        obs.get().registry.log_event(f"serve_rank_{what}", rank=rank,
                                     round=self.steps_run)
        if self.health:
            self.health.recorder.note(f"rank_{what}", rank=rank,
                                      round=self.steps_run)

    def _breaker_tick(self) -> None:
        """One serve round of every breaker: a rank OPEN past its
        cooldown goes HALF_OPEN and gets one timed re-probe
        (``probe_fn``); a pass closes the breaker (full routing from the
        next round), a failure or a hang opens it again."""
        recovered = self.breaker.tick(self.steps_run, probe=self.probe_fn,
                                      timeout_s=self.scfg.probe_timeout_s)
        for r in recovered:
            self._rank_event("recovered", r)
        if recovered:
            self._publish_mask()

    def _publish_mask(self) -> None:
        dead = self.breaker.dead_ranks
        obs.set_gauge("serve_degraded", float(bool(dead)))
        obs.set_gauge("serve_dead_ranks", float(len(dead)))

    @torch.no_grad()
    def _answer_degraded(self, reqs) -> None:
        """Answer queries owned by a dead rank from stale replicas: the
        first alive shard whose output cache holds the vertex (by its
        residency mirror; the row read by kernel B), else the first alive
        hot-tier replica.  A query with no replica anywhere gets zeros
        and ``served_by="degraded_dropped"``: bounded degradation, never
        a stall."""
        L = self.cfg.num_layers
        dim = serve_layer_dims(self.cfg)[-1]
        alive = [r for r in range(self.num_ranks)
                 if bool(self.breaker.alive[r])]
        for req in reqs:
            vid = req.vid
            src, tier = None, False
            if self.scfg.cache.enabled:
                src = next((r for r in alive
                            if self.cache.output_resident(r, vid)), None)
            if src is None and self.hot is not None:
                src = next((r for r in alive
                            if self.hot.output_resident(r, vid)), None)
                tier = src is not None
            if src is None:
                self.degraded_dropped += 1
                obs.count("serve_degraded_dropped")
                self._finish(req, np.zeros(dim, np.float32),
                             "degraded_dropped")
                continue
            vids = torch.full((self.num_ranks, 1), -1, dtype=torch.int32,
                              device=self.device)
            vids[src, 0] = vid
            if tier:
                _, emb = self._tier_lookup(self.hot.states[L - 1], vids)
            else:
                _, emb = self._lookup(self.cache.states[L - 1], vids)
            self.degraded_answers += 1
            obs.count("serve_degraded_answers")
            self._finish(req, emb[src, 0].cpu().numpy(), "degraded_replica")

    # -- internals ------------------------------------------------------------
    def audit(self, epoch: Optional[int] = None):
        """On-demand exactness audit across every shard: sample cached
        lines per layer (tags are VID_o, so the sharded offline pass's
        global ``[V, d]`` embeddings index them directly), recompute them
        exactly (``layerwise_embeddings_dist``: A or G, as the pre-warm),
        and publish the relative L2 error, with the hot replicas'
        divergence.  Shards warmed from the offline pass audit to exactly
        0.0."""
        q = self.quality
        if q is None:
            raise ValueError("audit needs DistGNNServeScheduler(quality=...)")
        from repro_torch.serve.gnn.distributed.offline import \
            layerwise_embeddings_dist
        exact = layerwise_embeddings_dist(self.cfg, self.model, self.ps)

        def rows(k, vids):
            return exact[k].index_select(0, torch.as_tensor(
                vids, dtype=torch.long, device=exact[k].device)).cpu().numpy()
        layer_samples = []
        for k in range(self.cache.num_layers):
            vids, cached, ages = self.cache.cached_entries(
                k, sample=q.cfg.audit_samples, rng=q.rng)
            layer_samples.append((k + 1, cached, rows(k, vids), ages))
        hot_samples = None
        if self.hot is not None:
            # per-layer pairs: the layers' widths differ, so the plane
            # concatenates error vectors, not rows
            hot_samples = []
            for k, st in enumerate(self.hot.states):
                vids, vals, _ = hot_lib.tier_entries(st, self.hot.hot_vids)
                if len(vids):
                    hot_samples.append((vals, rows(k, vids)))
            self.hot.publish_ages()
        q.publish_staleness(self.cache.states, layer_of=lambda i: i + 1)
        return q.run_audit(self.steps_run if epoch is None else epoch,
                           layer_samples, hot_samples=hot_samples,
                           source="serve_dist")

    def _record_rank_round(self, stats: dict, wall_s: float):
        """The round's per-rank stats (host arrays of the round's one
        copy) as rank-labeled series and cluster views, and one window of
        the health plane."""
        reg = obs.get().registry
        if not (reg.enabled or self.health):
            return
        dims = serve_layer_dims(self.cfg)
        R = self.num_ranks
        sum_layers = lambda a: a.sum(axis=1).astype(np.float64) \
            if a.ndim == 2 and a.shape[1] else np.zeros(R)  # noqa: E731
        fetched = stats["halo_fetched"]
        # a fetched row carries the layer's embedding and a 4-byte vid tag
        bytes_per_rank = np.zeros(R)
        for i in range(fetched.shape[1] if fetched.ndim == 2 else 0):
            bytes_per_rank += fetched[:, i].astype(np.float64) \
                * (dims[i] * 4 + 4)
        totals = {
            "rank_serve_lookups": sum_layers(stats["lookups"]),
            "rank_serve_hits": sum_layers(stats["hits"]),
            "rank_serve_halo_rows": sum_layers(stats["halo_seen"]),
            "rank_serve_halo_local": sum_layers(stats["halo_local"]),
            "rank_serve_halo_fetched": sum_layers(fetched),
            "rank_serve_halo_requested": sum_layers(stats["halo_requested"]),
            "rank_serve_halo_bytes": bytes_per_rank,
            "rank_serve_hot_hits": sum_layers(stats["hot_hits"]),
            "rank_serve_round_seconds": np.full(R, wall_s),
        }
        if reg.enabled:
            obs.publish_rank_series(reg, totals)
        if self.health:
            self.health.observe_round(totals, wall_s=wall_s,
                                      latency_hist=self.latency)

    def _split_fast_path(self, rank: int, wave):
        """(answerable without compute, needs compute): output-cache
        resident on the owner, or valid in the owner's hot replica."""
        hits, misses = [], []
        for entry in wave:
            vid = entry[0].vid
            ok = self.cache.output_resident(rank, vid) or (
                self.hot is not None
                and self.hot.output_resident(rank, vid))
            (hits if ok else misses).append(entry)
        return hits, misses

    @torch.no_grad()
    def _answer_fast_path(self, fast: List[List]) -> List[List]:
        """Stacked ``[R, slots]`` lookups answer every output-cache or
        tier-resident query without sampling or compute; returns per rank
        the entries the device unexpectedly missed (sent to the compute
        path, never re-queued)."""
        misses: List[List] = [[] for _ in range(self.num_ranks)]
        if not any(fast):
            return misses
        L = self.cfg.num_layers
        slots = self.scfg.num_slots
        for s in range(0, max(len(f) for f in fast), slots):
            chunk = [f[s:s + slots] for f in fast]
            vids = np.full((self.num_ranks, slots), -1, np.int32)
            for r, lst in enumerate(chunk):
                vids[r, :len(lst)] = [e[0].vid for e in lst]
            vt = torch.as_tensor(vids, device=self.device)
            hit, emb = self._lookup(self.cache.states[L - 1], vt)
            got = [hit, emb]
            if self.hot is not None:
                got += list(self._tier_lookup(self.hot.states[L - 1], vt))
            got = _host_copy(got)
            hit, emb = got[0], got[1]
            t_hit, t_emb = (got[2], got[3]) if self.hot is not None else \
                (np.zeros_like(hit), None)
            self.fast_path_rounds += 1
            for r, lst in enumerate(chunk):
                for i, entry in enumerate(lst):
                    if hit[r, i]:       # guaranteed by the residency mirror
                        self._finish(entry[0], emb[r, i].copy(),
                                     "output_cache")
                        self.cache.fast_path_hits += 1
                    elif t_hit[r, i]:   # hub answered from the local replica
                        self._finish(entry[0], t_emb[r, i].copy(),
                                     "hot_tier")
                        self.hot.fast_path_hits += 1
                    else:
                        misses[r].append(entry)
        return misses

    def _sample(self, round_groups: List[List]) -> dict:
        """Every shard's ``round_batch`` segments, sampled and fused, as
        stacked ``[R, ...]`` tensors."""
        NB = self.scfg.round_batch
        slots = self.scfg.num_slots
        blocks = []
        for r in range(self.num_ranks):
            expandable = self._expandable(r)
            segs = []
            for n in range(NB):
                grp = round_groups[r][n * slots:(n + 1) * slots]
                seeds = np.array([local for local, _ in grp], np.int64)
                rng = np.random.default_rng(
                    [self.scfg.sample_seed, self._mb_counter, r]
                    + ([n] if NB > 1 else []))
                segs.append(sample_blocks_vectorized(
                    self.ps.parts[r], seeds, self.cfg.fanouts, rng, slots,
                    expandable=expandable))
            blocks.append(concat_blocks(segs))
        self._mb_counter += 1
        host = stack_ranks(blocks)
        t = lambda a: torch.as_tensor(a, device=self.device)
        return {"seeds": t(host["seeds"]), "seed_mask": t(host["seed_mask"]),
                "nbr_idx": [t(x) for x in host["nbr_idx"]],
                "layer_nodes": [t(x) for x in host["layer_nodes"]],
                "node_mask": [t(x) for x in host["node_mask"]]}

    def _run_round(self, round_groups: List[List]):
        """Sample every shard's segments, run ONE step for all ranks, bring
        its results home in one copy, and give each slot's answer to every
        request of its group."""
        t0 = time.perf_counter()
        with obs.span("serve_round"):
            with obs.span("serve_sample"):
                mb = self._sample(round_groups)
            states = self.cache.states if self.scfg.cache.enabled \
                else self.cache.init_states()
            tstates = self.hot.states if self.hot is not None else []
            alive = None if self.breaker is None else torch.as_tensor(
                self.breaker.alive, device=self.device)
            with obs.span("serve_step"):
                out, out_valid, stats = self._step(states, tstates, mb,
                                                   alive)
            with obs.span("serve_sync_host"):
                names = list(stats)
                tags = [st.tags for st in states] \
                    if self.scfg.cache.enabled else []
                ages = [st.age for st in tstates]
                host = _host_copy([out, out_valid] + [stats[n] for n in names]
                                  + tags + ages)
                out, out_valid = host[0], host[1]
                stats = dict(zip(names, host[2:2 + len(names)]))
                self.cache.record(stats["hits"].sum(0),
                                  stats["lookups"].sum(0))
                self.cache.record_halo(stats)
                if self.scfg.cache.enabled:
                    self.cache.sync_host(host[2 + len(names):
                                              2 + len(names) + len(tags)])
                if self.hot is not None:
                    n_hot = int(stats["hot_hits"].sum())
                    self.hot.hot_hits += n_hot
                    obs.count("hot_hits", n_hot)
                    self.hot.sync_host(host[len(host) - len(ages):])
            self.steps_run += 1
            wall = time.perf_counter() - t0
            self.round_log.append({**{n: stats[n].tolist() for n in names},
                                   "wall_s": wall})
            self._record_rank_round(stats, wall)
            for r, groups in enumerate(round_groups):
                for i, (local, reqs) in enumerate(groups):
                    if out_valid[r, i]:
                        row = out[r, i].copy()
                        for req in reqs:
                            self._finish(req, row, "compute")
                    elif self.breaker is not None and self.breaker.any_dead:
                        # the row's neighbourhood lives on a dead rank:
                        # stale replicas or zeros, not a stalled round
                        self._answer_degraded(list(reqs))
                    else:
                        raise RuntimeError(
                            f"requests {[q.rid for q in reqs]} "
                            f"(vid {reqs[0].vid}) not served")
