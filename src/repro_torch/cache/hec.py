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

:class:`EmbeddingCache` is the single-rank serving cache (per-layer
states, host residency mirror, model-version invalidation, counters).
Training keeps one :class:`HECState` per (layer, rank) from
:func:`hec_init` (``train/gnn_trainer.py``) and copies them with
:func:`hec_clone` where the reference would compute on a throwaway
state; the rank-stacked serving variant waits for the sharded-serving
slice.
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


@dataclasses.dataclass
class HECState:
    tags: torch.Tensor      # [nsets, ways] int32
    age: torch.Tensor       # [nsets, ways] int32
    values: torch.Tensor    # [nsets, ways, dim] float32

    @property
    def nsets(self) -> int:
        return self.tags.shape[0]

    @property
    def ways(self) -> int:
        return self.tags.shape[1]


def hec_init(cache_size: int, ways: int, dim: int,
             device: torch.device) -> HECState:
    if cache_size % ways:
        raise ValueError(f"cache_size {cache_size} is not a multiple of "
                         f"ways {ways}")
    nsets = cache_size // ways
    return HECState(
        tags=torch.full((nsets, ways), -1, dtype=torch.int32, device=device),
        age=torch.zeros((nsets, ways), dtype=torch.int32, device=device),
        values=torch.zeros((nsets, ways, dim), dtype=torch.float32,
                           device=device))


def hec_tick(state: HECState, life_span: int) -> HECState:
    """Advance one iteration in place: age lines, purge those older than ls."""
    state.age += 1
    expired = state.age > life_span
    state.tags.masked_fill_(expired, -1)
    state.age.masked_fill_(expired, 0)
    return state


def hec_store(state: HECState, vids: torch.Tensor, embs: torch.Tensor,
              valid: Optional[torch.Tensor] = None) -> HECState:
    """Scatter ``embs [n, dim]`` of ``vids [n]`` into the cache, in place.

    Way choice per entry: matching tag, else the first empty way, else the
    oldest (OCF).  The r-th batch entry that lands in a set takes
    ``(way + r) % ways`` (r counts invalid entries too), so up to ``ways``
    same-set entries occupy distinct lines.  Beyond that several entries
    share a (set, way): the last one in batch order is written, as the
    reference's scatter does on the CPU.  Invalid entries (``valid`` False,
    default ``vids < 0``) are dropped.
    """
    if valid is None:
        valid = vids >= 0
    nsets, ways = state.tags.shape
    n = vids.shape[0]
    if n == 0:
        return state
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


def hec_lookup(state: HECState, vids: torch.Tensor):
    """(hit [m], emb [m, dim]) with misses zeroed: one probe + load."""
    hit, _, _, emb = hec_kernel.hec_lookup(
        state.tags, state.values, vids.to(torch.int32).contiguous())
    return hit, emb


def hec_clone(state: HECState) -> HECState:
    """A copy that in-place updates of ``state`` do not reach."""
    return HECState(tags=state.tags.clone(), age=state.age.clone(),
                    values=state.values.clone())


def hec_occupancy(state: HECState) -> float:
    return float((state.tags >= 0).float().mean())


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
    """Per-layer HEC states + host residency mirror + counters (one rank).

      * no life-span ticks: entries stay valid until evicted (OCF within a
        set) or dropped by a model-version bump (``on_model_update``),
      * the host residency mirror is rebuilt from the device tags after
        every store batch (``sync_host``), and all lookups of a microbatch
        precede all of its stores — so a sampling leaf decided from the
        mirror is always backed by a device hit,
      * hit/miss/occupancy counters.
    """

    def __init__(self, dims: Sequence[int], num_vertices: int,
                 cfg: Optional[ServeCacheConfig] = None,
                 device: DeviceLike = None):
        self.cfg = cfg or ServeCacheConfig()
        self.dims = list(dims)                 # dims of h^1 .. h^L
        self.num_vertices = num_vertices
        self.device = resolve_device(device)
        self.model_version = 0
        self._reset_states()
        self.hits = np.zeros(len(dims), np.int64)
        self.lookups = np.zeros(len(dims), np.int64)
        self.fast_path_hits = 0                # queries answered w/o compute

    @property
    def num_layers(self) -> int:
        return len(self.dims)

    def init_states(self) -> List[HECState]:
        """Fresh (empty) states — also the disabled-cache baseline."""
        c = self.cfg
        return [hec_init(c.cache_size, c.ways, d, self.device)
                for d in self.dims]

    def _reset_states(self):
        self.states = self.init_states()
        self.resident = [np.zeros(self.num_vertices, bool) for _ in self.dims]

    def sync_host(self):
        """Rebuild the host residency flags from the device tags."""
        V = self.num_vertices
        for k, st in enumerate(self.states):
            tags = st.tags.cpu().numpy().ravel()
            flags = np.zeros(V, bool)
            flags[tags[(tags >= 0) & (tags < V)]] = True
            self.resident[k] = flags

    def expandable_masks(self) -> List[Optional[np.ndarray]]:
        """``expandable[k]`` for ``sample_blocks_vectorized``: a node at
        layer ``k`` is a leaf iff its ``h^k`` is cache-resident."""
        if not self.cfg.enabled:
            return [None] * (self.num_layers + 1)
        return [None] + [~r for r in self.resident]

    def warm(self, embeddings: Sequence[torch.Tensor], vids,
             chunk: int = 4096) -> int:
        """Store offline embeddings (``[V, d_k]`` per layer) of ``vids`` into
        every layer, ``chunk`` vertices per store batch; returns the number
        of vertices stored per layer."""
        vids = np.asarray(vids, np.int64)
        for k, emb in enumerate(embeddings):
            for s in range(0, len(vids), chunk):
                v = torch.as_tensor(vids[s:s + chunk], device=emb.device)
                hec_store(self.states[k], v, emb[v])
        self.sync_host()
        return len(vids)

    def record(self, hits: np.ndarray, lookups: np.ndarray):
        self.hits += hits.astype(np.int64)
        self.lookups += lookups.astype(np.int64)
        for k in range(len(self.hits)):
            obs.count("serve_cache_hits", int(hits[k]), layer=k + 1)
            obs.count("serve_cache_lookups", int(lookups[k]), layer=k + 1)

    def reset_counters(self):
        """Zero hit/lookup/fast-path counters (cache contents untouched)."""
        self.hits[:] = 0
        self.lookups[:] = 0
        self.fast_path_hits = 0

    def metrics(self) -> dict:
        out = {"model_version": self.model_version,
               "fast_path_hits": self.fast_path_hits}
        for k in range(self.num_layers):
            layer = k + 1
            out[f"hits_l{layer}"] = int(self.hits[k])
            out[f"lookups_l{layer}"] = int(self.lookups[k])
            out[f"hit_rate_l{layer}"] = (
                float(self.hits[k]) / max(int(self.lookups[k]), 1))
            out[f"occupancy_l{layer}"] = hec_occupancy(self.states[k])
        return out

    def on_model_update(self) -> int:
        """Model-version bump: every cached embedding is stale — drop all."""
        self.model_version += 1
        self._reset_states()
        return self.model_version
