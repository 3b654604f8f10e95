"""Batched GNN inference scheduler: fixed-shape microbatches over the
on-demand sampler, with HEC-backed reuse of overlapping neighborhoods —
counterpart of ``repro/serve/gnn/scheduler.py`` (GraphSAGE or GAT, one
rank).

Per-vertex requests queue up and are packed into microbatches of exactly
``num_slots`` seeds.  Each microbatch:

  1. **cache-aware sampling** (host): queries whose *output* embedding is
     resident are answered by one fixed-shape probe of the output cache
     and never take a slot; the rest are sampled with
     ``sample_blocks_vectorized(expandable=...)`` so any vertex whose
     layer-k embedding is resident becomes a leaf,
  2. **serve step** (device): the model's forward (per layer one fused
     serve-layer kernel launch for GraphSAGE; ``torch.addmm`` and one GAT
     AGG kernel launch for GAT), with a hook that substitutes cached
     embeddings (one fused HEC probe + load launch per hidden layer, one
     more for the seeds), then every freshly computed layer-k embedding
     is stored back (``hec_store``, torch ops),
  3. **residency sync** (host): the device tags are mirrored back so the
     next microbatch's sampling sees the new contents.

All lookups of a microbatch read the cache before any store, so a leaf
decided at sampling time is always backed by a device hit.
``update_params`` installs a new model and bumps the cache's model
version, dropping every cached embedding.

Admission control (``max_queue_depth``: ``submit`` raises
``AdmissionRejected``), per-request latency p50/p99 and cross-query dedup
(``dedup=True``: same-vid queries pending together share one slot) follow
the reference; :class:`ServeFrontend` holds the request lifecycle the
sharded scheduler (``serve/gnn/distributed``) shares.  The health and
quality planes are not ported yet.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.cache import hec as hec_lib
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graph.partition import Partition
from repro_torch.pipeline.vectorized_sampler import sample_blocks_vectorized
from repro_torch.serve.gnn.embedding_cache import (ServeCacheConfig,
                                                   ServingCache)
from repro_torch.serve.gnn.offline import serve_layer_dims


@dataclasses.dataclass(frozen=True)
class GNNServeConfig:
    num_slots: int = 64            # seeds per microbatch (fixed shape)
    cache: ServeCacheConfig = dataclasses.field(
        default_factory=ServeCacheConfig)
    sample_seed: int = 0           # base seed of the per-microbatch RNG
    max_queue_depth: Optional[int] = None  # admission cap; None = unbounded
    dedup: bool = False            # same-vid queries share ONE compute slot


class AdmissionRejected(RuntimeError):
    """Raised by ``submit`` when the queue is at ``max_queue_depth``: the
    query is rejected with immediate backpressure, never silently dropped."""


@dataclasses.dataclass
class GNNRequest:
    rid: int
    vid: int
    result: Optional[np.ndarray] = None   # [num_classes] once served
    model_version: int = -1               # version that served it
    served_by: str = ""                   # "output_cache" | "compute"
    t_submit: float = 0.0                 # perf_counter at enqueue
    t_done: float = 0.0                   # perf_counter at answer

    @property
    def done(self) -> bool:
        return self.result is not None


class ServeFrontend:
    """Request lifecycle shared by the single-rank and sharded schedulers:
    admission control, latency stamping, served/rejected counters."""

    def _init_frontend(self):
        self._rid = 0
        self._mb_counter = 0
        self.latency = obs.Histogram()
        self.reset_frontend()

    def reset_frontend(self):
        """Zero steps/served/rejected counters and the latency window
        (request ids keep advancing; queued requests are untouched)."""
        self.steps_run = 0
        self.queries_served = 0
        self.queries_rejected = 0
        self.dedup_merged = 0          # queries answered by a shared slot
        self.latency.reset()

    def _admit(self, vid: int, queue_depth: int) -> GNNRequest:
        """A new request, or ``AdmissionRejected`` when the queue is at
        ``max_queue_depth``."""
        cap = self.scfg.max_queue_depth
        if cap is not None and queue_depth >= cap:
            self.queries_rejected += 1
            raise AdmissionRejected(
                f"queue at max_queue_depth={cap}; query {int(vid)} rejected")
        req = GNNRequest(rid=self._rid, vid=int(vid),
                         t_submit=time.perf_counter())
        self._rid += 1
        return req

    def _finish(self, req: GNNRequest, result: np.ndarray, served_by: str):
        req.result = result
        req.model_version = self.cache.model_version
        req.served_by = served_by
        req.t_done = time.perf_counter()
        self.latency.observe(req.t_done - req.t_submit)
        obs.observe("serve_latency_s", req.t_done - req.t_submit,
                    subsystem="serve")
        self.queries_served += 1

    def _frontend_metrics(self, queue_depth: int) -> dict:
        out = {"steps_run": self.steps_run,
               "queries_served": self.queries_served,
               "queries_rejected": self.queries_rejected,
               "dedup_merged": self.dedup_merged,
               "queue_depth": queue_depth}
        out.update(self.latency.metrics())
        return out


class GNNServeScheduler(ServeFrontend):
    def __init__(self, cfg, model, part: Partition,
                 serve_cfg: Optional[GNNServeConfig] = None,
                 device: DeviceLike = None):
        if part.num_halo:
            raise ValueError("serving is single-partition")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.scfg = serve_cfg or GNNServeConfig()
        self.part = part
        self.model = model.to(self.device)
        self.features = torch.as_tensor(part.features, dtype=torch.float32,
                                        device=self.device)
        self.cache = ServingCache(serve_layer_dims(cfg), part.num_solid,
                                  self.scfg.cache, device=self.device)
        self.queue: deque[GNNRequest] = deque()
        self._init_frontend()

    # -- request lifecycle ---------------------------------------------------
    def submit(self, vid: int) -> GNNRequest:
        req = self._admit(vid, len(self.queue))
        self.queue.append(req)
        return req

    def pump(self) -> int:
        """Serve everything queued; returns microbatches executed."""
        ran = 0
        # pending compute work as groups (vid, [requests]); with dedup on,
        # repeat queries for one vertex share one compute slot
        pending: List = []
        index: dict = {}
        while self.queue or pending:
            # fill a full microbatch with cache misses: output-cache hits
            # are answered inline and never occupy a slot
            while self.queue and len(pending) < self.scfg.num_slots:
                n = min(len(self.queue),
                        self.scfg.num_slots - len(pending))
                wave = [self.queue.popleft() for _ in range(n)]
                misses = (self._answer_from_output_cache(wave)
                          if self.scfg.cache.enabled else wave)
                for req in misses:
                    if self.scfg.dedup and req.vid in index:
                        index[req.vid][1].append(req)
                        self.dedup_merged += 1
                    else:
                        g = (req.vid, [req])
                        pending.append(g)
                        if self.scfg.dedup:
                            index[req.vid] = g
            if pending:
                take = pending[:self.scfg.num_slots]
                self._run_microbatch(take)
                for vid, _ in take:
                    index.pop(vid, None)
                pending = pending[self.scfg.num_slots:]
                ran += 1
        return ran

    def serve(self, vids: Sequence[int]) -> np.ndarray:
        """Submit ``vids``, pump, return outputs in order."""
        reqs = [self.submit(v) for v in vids]
        self.pump()
        return np.stack([r.result for r in reqs])

    def update_params(self, model) -> int:
        """Install a new model; stale cached embeddings are dropped."""
        self.model = model.to(self.device)
        return self.cache.on_model_update()

    def metrics(self) -> dict:
        out = self.cache.metrics()
        out.update(self._frontend_metrics(len(self.queue)))
        return out

    # -- device step ---------------------------------------------------------
    def _tensor(self, x: np.ndarray, dtype) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def _sample(self, vids: Sequence[int]) -> dict:
        rng = np.random.default_rng(
            [self.scfg.sample_seed, self._mb_counter])
        self._mb_counter += 1
        with obs.span("serve_sample"):
            blocks = sample_blocks_vectorized(
                self.part, np.asarray(vids, np.int64), self.cfg.fanouts,
                rng, self.scfg.num_slots,
                expandable=self.cache.expandable_masks())
        i32, b8 = torch.int32, torch.bool
        return {
            "seeds": self._tensor(blocks.seeds, i32),
            "seed_mask": self._tensor(blocks.seed_mask, b8),
            "nbr_idx": [self._tensor(x, i32) for x in blocks.nbr_idx],
            "layer_nodes": [self._tensor(x, i32) for x in blocks.layer_nodes],
            "node_mask": [self._tensor(x, b8) for x in blocks.node_mask],
        }

    @torch.no_grad()
    def _step(self, states: List[hec_lib.HECState], mb: dict):
        """Forward with cached-embedding substitution, then store-back.
        Returns (out [B, C], out_valid [B], hits [L], lookups [L])."""
        L = self.cfg.num_layers
        nodes0 = mb["layer_nodes"][0].long()
        mask0 = mb["node_mask"][0]
        h0 = self.features[nodes0.clamp(0, self.features.shape[0] - 1)] \
            * mask0[:, None]
        captured = {}
        hits, lookups = [], []

        def hook(k, h, valid):
            if k == 0:
                return h, valid
            maskk = mb["node_mask"][k]
            hit, emb = hec_lib.hec_lookup(states[k - 1],
                                          mb["layer_nodes"][k])
            hit = hit & maskk
            h = torch.where(hit[:, None], emb, h)
            valid = (valid | hit) & maskk
            hits.append(hit.sum())
            lookups.append(maskk.sum())
            captured[k] = (h, valid)
            return h, valid

        out, valid = self.model(h0, mask0, {"nbr_idx": mb["nbr_idx"]},
                                halo_hook=hook)
        B = mb["seeds"].shape[0]
        out = out[:B]
        seed_vids = mb["seeds"]
        hitL, embL = hec_lib.hec_lookup(states[L - 1], seed_vids)
        hitL = hitL & mb["seed_mask"]
        out = torch.where(hitL[:, None], embL, out)
        out_valid = (valid[:B] | hitL) & mb["seed_mask"]
        hits.append(hitL.sum())
        lookups.append(mb["seed_mask"].sum())

        # store-back after every lookup: newly computed (or refreshed)
        # layer-k embeddings enter the cache for later microbatches
        for k in range(1, L):
            h_k, valid_k = captured[k]
            hec_lib.hec_store(states[k - 1],
                              torch.where(valid_k, mb["layer_nodes"][k], -1),
                              h_k)
        hec_lib.hec_store(states[L - 1], torch.where(out_valid, seed_vids, -1),
                          out)
        return out, out_valid, torch.stack(hits), torch.stack(lookups)

    # -- internals -----------------------------------------------------------
    def _answer_from_output_cache(self, wave: List[GNNRequest]):
        """Answer output-cache-resident queries without sampling or compute;
        returns the requests that still need a microbatch."""
        L = self.cfg.num_layers
        flags = self.cache.resident[L - 1]
        candidates = [r for r in wave if flags[r.vid]]
        misses = [r for r in wave if not flags[r.vid]]
        if candidates:
            vids = np.full(self.scfg.num_slots, -1, np.int32)
            vids[:len(candidates)] = [r.vid for r in candidates]
            hit, emb = hec_lib.hec_lookup(self.cache.states[L - 1],
                                          self._tensor(vids, torch.int32))
            hit, emb = hit.cpu().numpy(), emb.cpu().numpy()
            for i, r in enumerate(candidates):
                if hit[i]:              # guaranteed by the residency mirror
                    self._finish(r, emb[i], "output_cache")
                    self.cache.fast_path_hits += 1
                else:                   # defensive: mirror out of sync
                    misses.append(r)
        return misses

    def _run_microbatch(self, groups: List):
        """One serve step over the groups' unique vids; every request in a
        group receives the same slot's answer (dedup scatter-back)."""
        with obs.span("serve_round"):
            mb = self._sample([vid for vid, _ in groups])
            states = self.cache.states
            if not self.scfg.cache.enabled:
                # baseline mode: every microbatch sees an empty cache
                states = self.cache.init_states()
            with obs.span("serve_step"):
                out, out_valid, hits, lookups = self._step(states, mb)
                out = out.cpu().numpy()         # waits for the device
                out_valid = out_valid.cpu().numpy()
            self.cache.record(hits.cpu().numpy(), lookups.cpu().numpy())
            if self.scfg.cache.enabled:
                with obs.span("serve_sync_host"):
                    self.cache.sync_host()
            self.steps_run += 1
            for i, (vid, reqs) in enumerate(groups):
                if not out_valid[i]:
                    raise RuntimeError(
                        f"requests {[q.rid for q in reqs]} (vid {vid}) "
                        f"not served")
                for req in reqs:
                    self._finish(req, out[i], "compute")
