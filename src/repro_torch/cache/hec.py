"""The Historical Embedding Cache (paper §3.2) over torch tensors —
counterpart of ``repro/cache/hec.py`` (single-rank part).

A set-associative cache over dense tensors, searched with a
hash -> set -> way compare and replaced OCF *within the set*:

    state.tags   [nsets, ways] int32   VID tag, -1 = empty
    state.age    [nsets, ways] int32   iterations since fill
    state.values [nsets, ways, dim]    the historical embedding

Replacement: matching tag > empty way > oldest way; up to ``ways``
same-set entries of one store batch take distinct ways (``hec_store``).

Unlike the reference's pure functions, ``hec_tick`` and ``hec_store``
update the state **in place** (and return it): a serve step makes every
lookup before its first store, so the in-place update gives the
reference's results without copying the value tensors.  ``hec_lookup``
on CUDA tensors is one launch of the fused probe + load kernel
(``kernels/hec_search.py``).

:class:`EmbeddingCache` is the serving cache (per-layer states, host
residency mirror, model-version invalidation, counters): single-rank, or
with ``ps=PartitionSet`` one state per layer stacked ``[R, ...]`` over
the shards, tagged by VID_o.  Training keeps one :class:`HECState` per
(layer, rank) from :func:`hec_init` (``train/gnn_trainer.py``); where the
reference computes on a throwaway state (``evaluate``), the trainer keeps
the tags and ages and the value rows its stores overwrite (``undo``) and
puts them back.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import hec_search as hec_kernel
from repro_torch.kernels.ref import set_index

_set_index = set_index          # the reference's older name


@dataclasses.dataclass
class HECState:
    tags: torch.Tensor      # [nsets, ways] int32
    age: torch.Tensor       # [nsets, ways] int32
    values: torch.Tensor    # [nsets, ways, dim] float32

    @property
    def nsets(self) -> int:
        return self.tags.shape[-2]

    @property
    def ways(self) -> int:
        return self.tags.shape[-1]

    def rank(self, r: int) -> "HECState":
        """Rank ``r``'s cache of a rank-stacked state (``tags [R, nsets,
        ways]``): views, so in-place updates reach the stack."""
        return HECState(tags=self.tags[r], age=self.age[r],
                        values=self.values[r])


def hec_init(cache_size: int, ways: int, dim: int, device: torch.device,
             num_ranks: Optional[int] = None) -> HECState:
    """An empty cache, or ``num_ranks`` of them stacked on a leading axis."""
    if cache_size % ways:
        raise ValueError(f"cache_size {cache_size} is not a multiple of "
                         f"ways {ways}")
    nsets = cache_size // ways
    lead = () if num_ranks is None else (num_ranks,)
    return HECState(
        tags=torch.full(lead + (nsets, ways), -1, dtype=torch.int32,
                        device=device),
        age=torch.zeros(lead + (nsets, ways), dtype=torch.int32,
                        device=device),
        values=torch.zeros(lead + (nsets, ways, dim), dtype=torch.float32,
                           device=device))


def hec_tick(state: HECState, life_span: int) -> HECState:
    """Advance one iteration in place: age lines, purge those older than ls."""
    state.age += 1
    expired = state.age > life_span
    state.tags.masked_fill_(expired, -1)
    state.age.masked_fill_(expired, 0)
    return state


def hec_store(state: HECState, vids: torch.Tensor, embs: torch.Tensor,
              valid: Optional[torch.Tensor] = None,
              undo: Optional[list] = None) -> HECState:
    """Scatter ``embs [n, dim]`` of ``vids [n]`` into the cache, in place.

    Way choice per entry: matching tag, else the first empty way, else the
    oldest (OCF).  The r-th batch entry that lands in a set takes
    ``(way + r) % ways`` (r counts invalid entries too), so up to ``ways``
    same-set entries occupy distinct lines.  Beyond that several entries
    share a (set, way): the last one in batch order is written, as the
    reference's scatter does on the CPU.  Invalid entries (``valid`` False,
    default ``vids < 0``) are dropped.  ``undo``, if given, gets
    ``(values, index, rows)``: the value rows this store overwrites, so
    that :func:`undo_stores` can put them back.
    """
    if valid is None:
        valid = vids >= 0
    nsets, ways = state.tags.shape
    n = vids.shape[0]
    if n == 0:
        return state
    valid = valid.to(state.tags.device)
    dev = state.tags.device
    vids = vids.to(device=dev, dtype=torch.int64)
    s = set_index(vids, nsets)                              # [n] int64
    set_tags = state.tags[s]                                # [n, ways]
    match = set_tags == vids[:, None]
    empty = set_tags < 0
    oldest = state.age[s].argmax(dim=1)                     # first max
    first_empty = empty.to(torch.int32).argmax(dim=1)
    first_match = match.to(torch.int32).argmax(dim=1)
    way = torch.where(match.any(dim=1), first_match,
                      torch.where(empty.any(dim=1), first_empty, oldest))
    # rank of each entry among the batch entries of its set (stable order)
    order = torch.argsort(s, stable=True)
    s_sorted = s[order]
    first_pos = torch.searchsorted(s_sorted, s_sorted, side="left")
    rank = torch.empty_like(s)
    rank[order] = torch.arange(n, device=dev) - first_pos
    way = (way + rank) % ways
    # keep the last valid entry of each (set, way), so the scatter below
    # has no duplicate targets (their order would be undefined on CUDA)
    pos = torch.arange(n, device=dev)
    line = s * ways + way
    keep_pos = torch.where(valid, pos, -1)
    last = torch.full((nsets * ways,), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, line, keep_pos, reduce="amax")
    keep = valid & (last[line] == pos)
    ks, kw = s[keep], way[keep]
    if undo is not None:
        undo.append((state.values, (ks, kw), state.values[ks, kw]))
    state.tags[ks, kw] = vids[keep].to(torch.int32)
    state.age[ks, kw] = 0
    state.values[ks, kw] = embs.to(device=dev,
                                   dtype=state.values.dtype)[keep]
    return state


def hec_search(state: HECState, vids: torch.Tensor):
    """vids [m] -> (hit [m] bool, set_idx [m] int32, way_idx [m] int32)."""
    hit, s, w, _ = hec_kernel.hec_lookup(state.tags, state.values,
                                         vids.to(torch.int32).contiguous())
    return hit, s, w


def hec_load(state: HECState, set_idx: torch.Tensor,
             way_idx: torch.Tensor) -> torch.Tensor:
    """The value rows at ``(set_idx, way_idx)``, detached (historical)."""
    return state.values[set_idx.long(), way_idx.long()].detach()


def hec_lookup(state: HECState, vids: torch.Tensor):
    """(hit [m], emb [m, dim]) with misses zeroed: one probe + load."""
    hit, _, _, emb = hec_kernel.hec_lookup(
        state.tags, state.values, vids.to(torch.int32).contiguous())
    return hit, emb


def undo_stores(undo: list):
    """Put back the value rows the stores that filled ``undo`` overwrote
    (:func:`hec_store`, ``hot_tier.tier_store``), latest first."""
    for values, index, rows in reversed(undo):
        values[index] = rows
    undo.clear()


def hec_clone(state: HECState) -> HECState:
    """A copy that in-place updates of ``state`` do not reach."""
    return HECState(tags=state.tags.clone(), age=state.age.clone(),
                    values=state.values.clone())


def hec_occupancy(state: HECState) -> float:
    """Filled share of the lines (of every rank's, for a stacked state)."""
    return float((state.tags >= 0).float().mean())


# -- host-side reads (the quality plane's) -----------------------------------
def hec_valid_ages(state) -> np.ndarray:
    """Ages of the tagged lines, flattened on the host; a stacked state,
    or a list of per-rank states, flattens rank by rank.  Never mutates
    the cache."""
    from repro_torch.obs.quality import valid_ages
    return valid_ages(state)


def hec_entries(state, sample: Optional[int] = None,
                rng: Optional[np.random.Generator] = None):
    """Host-side ``(vids, values, ages)`` of the valid lines (of every
    rank's, rank by rank, for a stacked state or a per-rank list);
    ``sample`` caps the count (uniform without replacement from ``rng``),
    and only the sampled value rows leave the device."""
    from repro_torch.obs.quality import cache_entries
    return cache_entries(state, sample=sample, rng=rng)


@dataclasses.dataclass(frozen=True)
class ServeCacheConfig:
    """Serving-cache parameters (per layer)."""
    cache_size: int = 32768        # entries per layer
    ways: int = 8                  # set-associativity
    enabled: bool = True           # False: serve every query by full compute

    def __post_init__(self):
        if self.cache_size % self.ways:
            raise ValueError("cache_size must be a multiple of ways")


class EmbeddingCache:
    """Per-layer HEC states + host residency mirror + counters.

    Two policies, selected by construction:

      * ``ps=None`` — ONE state per layer, tags in the local vertex id
        space (single-partition serving),
      * ``ps=PartitionSet`` — per layer one state stacked ``[R, ...]`` on a
        leading rank axis (``HECState.rank(r)`` is rank r's cache), tags
        are **VID_o** so a shard caches embeddings of vertices it does
        *not* own (fetched halos stop traveling), with per-shard
        residency mirrors, owner-routed ``warm`` and halo counters.

    Shared semantics:

      * no life-span ticks: entries stay valid until evicted (OCF within a
        set) or dropped by a model-version bump (``on_model_update``),
      * the host residency mirror is rebuilt from the device tags after
        every store batch (``sync_host``), and all lookups of a microbatch
        precede all of its stores — so a sampling leaf decided from the
        mirror is always backed by a device hit,
      * hit/miss/occupancy (and, stacked, halo-gather) counters.
    """

    def __init__(self, dims: Sequence[int], num_vertices: int,
                 cfg: Optional[ServeCacheConfig] = None, ps=None,
                 device: DeviceLike = None):
        self.cfg = cfg or ServeCacheConfig()
        self.dims = list(dims)                 # dims of h^1 .. h^L
        self.num_vertices = num_vertices       # tag space (global V if ps)
        self.ps = ps
        self.num_ranks = ps.num_parts if ps is not None else None
        self.device = resolve_device(device)
        self.model_version = 0
        if ps is not None:
            self._vid_p_to_o = [p.vid_p_to_o() for p in ps.parts]
        self._reset_states()
        self.hits = np.zeros(len(dims), np.int64)
        self.lookups = np.zeros(len(dims), np.int64)
        self.fast_path_hits = 0                # queries answered w/o compute
        self.halo_seen = 0          # halo rows at hidden layers (h^k needed)
        self.halo_local = 0         # answered from the local shard's cache
        self.halo_fetched = 0       # answered by the owner via all_to_all
        self.halo_requested = 0     # rows that actually traveled
        self.halo_l0 = 0            # layer-0 rows served by the feature mirror

    @property
    def stacked(self) -> bool:
        return self.num_ranks is not None

    @property
    def num_layers(self) -> int:
        return len(self.dims)

    def init_states(self) -> List[HECState]:
        """Fresh (empty) states — also the disabled-cache baseline."""
        c = self.cfg
        return [hec_init(c.cache_size, c.ways, d, self.device,
                         num_ranks=self.num_ranks) for d in self.dims]

    def _reset_states(self):
        self.states = self.init_states()
        shape = (self.num_ranks, self.num_vertices) if self.stacked \
            else (self.num_vertices,)
        self.resident = [np.zeros(shape, bool) for _ in self.dims]

    def sync_host(self, tags: Optional[Sequence[np.ndarray]] = None):
        """Rebuild the host residency flags from the device tags (``tags``:
        host copies of every layer's tags, when the caller already holds
        them)."""
        V = self.num_vertices
        if tags is None:
            tags = [st.tags.cpu().numpy() for st in self.states]
        for k, t in enumerate(tags):
            if self.stacked:
                t = np.asarray(t).reshape(self.num_ranks, -1)
                flags = np.zeros((self.num_ranks, V), bool)
                for r in range(self.num_ranks):
                    tr = t[r][(t[r] >= 0) & (t[r] < V)]
                    flags[r, tr] = True
            else:
                t = np.asarray(t).ravel()
                flags = np.zeros(V, bool)
                flags[t[(t >= 0) & (t < V)]] = True
            self.resident[k] = flags

    def expandable_masks(self, rank: Optional[int] = None) \
            -> List[Optional[np.ndarray]]:
        """``expandable[k]`` for ``sample_blocks_vectorized``: a node at
        layer ``k`` is a leaf iff its ``h^k`` is cache-resident.  A stacked
        cache takes the shard's ``rank``: its masks are over that shard's
        VID_p space (a resident halo additionally skips the wire)."""
        if not self.cfg.enabled:
            return [None] * (self.num_layers + 1)
        if rank is None:
            if self.stacked:
                raise ValueError("a stacked cache needs a shard rank")
            return [None] + [~r for r in self.resident]
        vo = self._vid_p_to_o[rank]
        return [None] + [~r[rank][vo] for r in self.resident]

    def output_resident(self, rank: int, vid_o: int) -> bool:
        """Router fast path: is the final-layer embedding on the shard?"""
        if not self.stacked:
            raise ValueError("output_resident is per shard (stacked only)")
        return bool(self.resident[self.num_layers - 1][rank, vid_o])

    def warm(self, embeddings: Sequence[torch.Tensor], vids,
             chunk: int = 4096, layers: Optional[Sequence[int]] = None) -> int:
        """Store offline embeddings (``[V, d_k]`` per layer) of ``vids``,
        ``chunk`` vertices per store batch; returns the number of vertices
        stored per layer.  ``layers`` restricts which cache layers are
        warmed (default: all).  A stacked cache routes each vertex to its
        owner's shard, ``chunk`` per shard per batch."""
        layer_set = set(range(len(self.dims))) if layers is None \
            else set(layers)
        vids = np.asarray(vids, np.int64)
        if not self.stacked:
            for k, emb in enumerate(embeddings):
                if k not in layer_set:
                    continue
                for s in range(0, len(vids), chunk):
                    v = torch.as_tensor(vids[s:s + chunk], device=emb.device)
                    hec_store(self.states[k], v, emb[v])
            self.sync_host()
            return len(vids)
        owner, _ = self.ps.route(vids) if len(vids) else (
            np.empty(0, np.int64), np.empty(0, np.int64))
        per_rank = [vids[owner == r] for r in range(self.num_ranks)]
        rounds = max((len(v) for v in per_rank), default=0)
        for s in range(0, max(rounds, 1), chunk):
            batch = np.full((self.num_ranks, chunk), -1, np.int64)
            for r, pv in enumerate(per_rank):
                seg = pv[s:s + chunk]
                batch[r, :len(seg)] = seg
            if not (batch >= 0).any():
                continue
            for k, emb in enumerate(embeddings):
                if k not in layer_set:
                    continue
                emb = torch.as_tensor(emb)
                for r in range(self.num_ranks):
                    b = torch.as_tensor(batch[r], device=emb.device)
                    vals = emb[b.clamp(min=0)] * (b >= 0)[:, None]
                    hec_store(self.states[k].rank(r), b, vals)
        self.sync_host()
        return len(vids)

    def record(self, hits: np.ndarray, lookups: np.ndarray):
        self.hits += hits.astype(np.int64)
        self.lookups += lookups.astype(np.int64)
        for k in range(len(self.hits)):
            obs.count("serve_cache_hits", int(hits[k]), layer=k + 1)
            obs.count("serve_cache_lookups", int(lookups[k]), layer=k + 1)

    def record_halo(self, stats: dict):
        """Accumulate a serve round's per-rank halo-gather counters."""
        if not self.stacked:
            raise ValueError("halo counters are per shard (stacked only)")
        for name in ("halo_seen", "halo_local", "halo_fetched",
                     "halo_requested", "halo_l0"):
            n = int(np.sum(stats[name]))
            setattr(self, name, getattr(self, name) + n)
            obs.count(f"serve_{name}", n)

    def reset_counters(self):
        """Zero hit/lookup/fast-path/halo counters (cache contents
        untouched)."""
        self.hits[:] = 0
        self.lookups[:] = 0
        self.fast_path_hits = 0
        self.halo_seen = self.halo_local = 0
        self.halo_fetched = self.halo_requested = self.halo_l0 = 0

    def cached_entries(self, layer: int, sample: Optional[int] = None,
                       rng: Optional[np.random.Generator] = None):
        """``(vids, values, ages)`` of layer ``layer``'s valid lines — the
        exactness audit's sampling hook (vids in this cache's tag space:
        VID_o when stacked, local otherwise)."""
        return hec_entries(self.states[layer], sample=sample, rng=rng)

    def occupancy(self) -> List[float]:
        return [hec_occupancy(st) for st in self.states]

    def metrics(self) -> dict:
        out = {"model_version": self.model_version,
               "fast_path_hits": self.fast_path_hits}
        if self.stacked:
            out.update({
                "num_shards": self.num_ranks,
                "halo_seen": self.halo_seen,
                "halo_local_hits": self.halo_local,
                "halo_fetched": self.halo_fetched,
                "halo_requested": self.halo_requested,
                "halo_l0_mirror": self.halo_l0,
                "cached_halo_frac": (
                    self.halo_local / self.halo_seen if self.halo_seen
                    else 0.0)})
        for k in range(self.num_layers):
            layer = k + 1
            out[f"hits_l{layer}"] = int(self.hits[k])
            out[f"lookups_l{layer}"] = int(self.lookups[k])
            out[f"hit_rate_l{layer}"] = (
                float(self.hits[k]) / max(int(self.lookups[k]), 1))
            out[f"occupancy_l{layer}"] = hec_occupancy(self.states[k])
        return out

    def on_model_update(self) -> int:
        """Model-version bump: every cached embedding (on every shard, if
        stacked) is stale — drop all."""
        self.model_version += 1
        self._reset_states()
        return self.model_version
