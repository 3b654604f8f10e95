"""Replicated hot-vertex tier over torch tensors — counterpart of
``repro/cache/hot_tier.py``.

On power-law graphs a few hub vertices are halos on almost every rank, so
their embeddings are fetched (serving) or pushed (training) pair by pair
over and over.  The hot tier replicates them instead:

  * the static **hot set** (``comm/plan.py:hot_set_tables``) — the top-K
    highest-degree vertices among those that are halos anywhere — gives
    every hub a dense slot (``searchsorted`` into the sorted ``hot_vids``
    table: no hashing, no eviction),
  * every rank holds a replica of all K slots per layer
    (``HotTierState``: ``values [K, dim]`` + ``age [K]``),
  * reads are local: a halo row whose hub slot is fresh in the local
    replica is served from it instead of the serve-side cache fetch (or,
    in training, the HEC),
  * ``tier_tick`` ages every slot; ``tier_lookup`` rejects slots older
    than a life-span (training passes the HEC's; ``None``: any filled
    slot, as serving uses it).

As in ``repro_torch.cache.hec``, ``tier_tick`` and ``tier_store`` update
the state **in place** (and return it).  :class:`HotTierCache` is the
serving object: per-layer replicas stacked ``[R, ...]``, the host
validity mirror, metrics and the model-version drop.  The quality
plane reads replica ages host-side (``replica_age_stats``,
``publish_replica_ages``, ``HotTierCache.publish_ages``) and samples
fresh replicas for its audit (``tier_entries``); none of them writes the
tier.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import DeviceLike, resolve_device

NEVER = 2 ** 30                 # age of a never-filled slot (always stale)


@dataclasses.dataclass
class HotTierState:
    values: torch.Tensor    # [K, dim] float32 (or [R, K, dim] stacked)
    age: torch.Tensor       # [K] int32, iterations since refresh (NEVER=empty)

    @property
    def num_slots(self) -> int:
        return self.age.shape[-1]

    def rank(self, r: int) -> "HotTierState":
        """Rank ``r``'s replica of a stacked state (views: in-place
        updates reach the stack)."""
        return HotTierState(values=self.values[r], age=self.age[r])


def tier_init(num_slots: int, dim: int, device,
              num_ranks: Optional[int] = None) -> HotTierState:
    """Empty replica(s): one, or ``num_ranks`` stacked on a leading axis."""
    lead = () if num_ranks is None else (num_ranks,)
    return HotTierState(
        values=torch.zeros(lead + (num_slots, dim), dtype=torch.float32,
                           device=device),
        age=torch.full(lead + (num_slots,), NEVER, dtype=torch.int32,
                       device=device))


def tier_slots(hot_vids: torch.Tensor, vids: torch.Tensor):
    """vids [m] VID_o -> (slot [m] int64, is_hot [m] bool).  ``hot_vids``
    is the sorted hot-set table (int64); the slot is its position."""
    K = hot_vids.shape[0]
    vids = vids.to(device=hot_vids.device, dtype=torch.int64)
    slot = torch.searchsorted(hot_vids, vids).clamp(0, K - 1)
    return slot, (hot_vids[slot] == vids) & (vids >= 0)


def tier_lookup(state: HotTierState, hot_vids: torch.Tensor,
                vids: torch.Tensor, life_span: Optional[int] = None):
    """vids [m] -> (hit [m], emb [m, dim]) with misses zeroed.
    ``life_span=None``: a filled slot stays fresh until it is dropped."""
    slot, is_hot = tier_slots(hot_vids, vids)
    age = state.age[slot]
    fresh = age < NEVER if life_span is None else age <= life_span
    hit = is_hot & fresh
    emb = torch.where(hit[:, None], state.values[slot],
                      torch.zeros((), dtype=state.values.dtype,
                                  device=state.values.device))
    return hit, emb


def tier_store(state: HotTierState, slots: torch.Tensor, embs: torch.Tensor,
               valid: Optional[torch.Tensor] = None,
               undo: Optional[list] = None) -> HotTierState:
    """Scatter fresh rows into their dense slots in place (age resets to
    0).  Rows with ``valid`` False (default: ``slots < 0``) are dropped.
    Where several valid rows name one slot, the last in batch order is
    written, as the reference's scatter does on the CPU.  ``undo`` as in
    ``hec.hec_store``."""
    K = state.num_slots
    n = slots.shape[0]
    if n == 0:
        return state
    dev = state.age.device
    s = slots.to(device=dev, dtype=torch.int64)
    valid = (s >= 0) if valid is None else valid.to(dev)
    valid = valid & (s >= 0) & (s < K)
    target = torch.where(valid, s, K)
    pos = torch.arange(n, device=dev)
    last = torch.full((K + 1,), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, target, torch.where(valid, pos, -1),
                         reduce="amax")
    keep = valid & (last[target] == pos)
    ks = s[keep]
    if undo is not None:
        undo.append((state.values, ks, state.values[ks]))
    state.values[ks] = embs.to(device=dev, dtype=state.values.dtype)[keep]
    state.age[ks] = 0
    return state


def tier_tick(state: HotTierState) -> HotTierState:
    """Advance one iteration in place: age every slot, saturating at
    NEVER so an empty slot never wraps into freshness."""
    state.age.add_(1).clamp_(max=NEVER)
    return state


def tier_entries(state: HotTierState, hot_vids: np.ndarray,
                 life_span: Optional[int] = None):
    """Host-side ``(vids, values, ages)`` of the fresh replica rows; a
    stacked ``[R, K, dim]`` state flattens across ranks.  Freshness as in
    :func:`tier_lookup`."""
    hot_vids = np.asarray(hot_vids, np.int64)
    K = len(hot_vids)
    dim = state.values.shape[-1]
    if not K:
        return (np.zeros(0, np.int64), np.zeros((0, dim), np.float32),
                np.zeros(0, np.int64))
    age = state.age.cpu().numpy().reshape(-1)
    vals = state.values.cpu().numpy().reshape(-1, dim)
    fresh = age < NEVER if life_span is None else age <= int(life_span)
    idx = np.flatnonzero(fresh)
    return hot_vids[idx % K], vals[idx], age[idx].astype(np.int64)


def replica_age_stats(states: Sequence[HotTierState],
                      life_span: Optional[int] = None) -> dict:
    """Per-layer replica age and refresh-lag stats, read host-side:
    ``hot_replica_filled_frac_l{l}``, and over the filled slots
    ``hot_refresh_lag_l{l}`` (their mean age), ``hot_replica_age_max_l{l}``
    and, with a ``life_span``, ``hot_replica_stale_frac_l{l}`` (the share a
    training lookup would reject); layers numbered from 1."""
    out = {}
    for l, st in enumerate(states, start=1):
        age = st.age.cpu().numpy().reshape(-1)
        filled = age < NEVER
        out[f"hot_replica_filled_frac_l{l}"] = (
            float(filled.mean()) if age.size else 0.0)
        if filled.any():
            fa = age[filled]
            out[f"hot_refresh_lag_l{l}"] = float(fa.mean())
            out[f"hot_replica_age_max_l{l}"] = float(fa.max())
            if life_span is not None:
                out[f"hot_replica_stale_frac_l{l}"] = \
                    float((fa > life_span).mean())
    return out


def publish_replica_ages(states: Sequence[HotTierState],
                         life_span: Optional[int] = None) -> dict:
    """:func:`replica_age_stats` as gauges, and the filled slots' ages of
    every layer and rank into the ``hot_replica_age`` histogram, in the
    active registry; returns the stats."""
    stats = replica_age_stats(states, life_span=life_span)
    reg = obs.get().registry
    if not reg.enabled:
        return stats
    for name, v in stats.items():
        reg.gauge(name).set(v)
    for st in states:
        age = st.age.cpu().numpy().reshape(-1)
        filled = age < NEVER
        if filled.any():
            reg.histogram("hot_replica_age").observe_many(age[filled])
    return stats


class HotTierCache:
    """Per-layer hot-tier replicas stacked ``[R, K, dim]`` for sharded
    serving.

    Every rank carries all K slots; ``warm`` stores the offline
    embeddings into every replica at once, and the serve step stores
    freshly computed or fetched hub rows into the *local* replica
    (per-rank validity: a cold replica falls back to the normal cache
    fetch, with the same answers).  Entries never age out;
    ``on_model_update`` drops every slot on every rank.
    """

    def __init__(self, dims: Sequence[int], hot_vids: np.ndarray,
                 num_ranks: int, device: DeviceLike = None):
        self.dims = list(dims)
        self.hot_vids = np.asarray(hot_vids, np.int64)
        self.num_ranks = num_ranks
        self.device = resolve_device(device)
        self.hot_vids_t = torch.as_tensor(self.hot_vids, device=self.device)
        self.hot_hits = 0              # halo rows served from the local tier
        self.fast_path_hits = 0        # queries answered from the output slot
        # dense vid -> slot table: O(1) membership per drained query
        size = int(self.hot_vids.max()) + 1 if len(self.hot_vids) else 0
        self._slot_table = np.full(size, -1, np.int64)
        if len(self.hot_vids):
            self._slot_table[self.hot_vids] = np.arange(len(self.hot_vids))
        self._reset_states()

    @property
    def num_slots(self) -> int:
        return len(self.hot_vids)

    @property
    def num_layers(self) -> int:
        return len(self.dims)

    def init_states(self) -> List[HotTierState]:
        K = max(self.num_slots, 1)
        return [tier_init(K, d, self.device, self.num_ranks)
                for d in self.dims]

    def _reset_states(self):
        self.states = self.init_states()
        self.valid = [np.zeros((self.num_ranks, max(self.num_slots, 1)),
                               bool) for _ in self.dims]

    def sync_host(self, ages: Optional[Sequence[np.ndarray]] = None):
        """Mirror per-replica slot validity from the ages (``ages``: host
        copies of every layer's ``[R, K]`` ages, when the caller already
        holds them).  All lookups of a round precede its stores, so a
        decision made from the mirror is always backed by a hit."""
        if ages is None:
            ages = [st.age.cpu().numpy() for st in self.states]
        self.valid = [np.asarray(a) < NEVER for a in ages]

    def slot_of(self, vids: np.ndarray) -> np.ndarray:
        """VID_o -> dense slot (or -1 when not hot)."""
        vids = np.asarray(vids, np.int64)
        if not self.num_slots:
            return np.full(vids.shape, -1, np.int64)
        inside = (vids >= 0) & (vids < len(self._slot_table))
        return np.where(inside,
                        self._slot_table[np.where(inside, vids, 0)], -1)

    def output_resident(self, rank: int, vid_o: int) -> bool:
        """Fast path: is the final-layer embedding in rank's replica?"""
        if vid_o >= len(self._slot_table):
            return False
        s = self._slot_table[vid_o]
        return bool(s >= 0 and self.valid[self.num_layers - 1][rank, s])

    def warm(self, embeddings: Sequence, vids=None) -> int:
        """Store offline embeddings (``[V, d_k]`` per layer) of the hot set
        into EVERY rank's replica; ``vids`` restricts which hot vertices
        are warmed (default: all K).  Returns the rows warmed."""
        if not self.num_slots:
            return 0
        take = self.hot_vids if vids is None else \
            self.hot_vids[np.isin(self.hot_vids, np.asarray(vids, np.int64))]
        if not len(take):
            return 0
        slots = torch.as_tensor(self.slot_of(take), device=self.device)
        for k, emb in enumerate(embeddings):
            emb = torch.as_tensor(emb)
            rows = emb[torch.as_tensor(take, device=emb.device)].to(
                device=self.device, dtype=torch.float32)
            for r in range(self.num_ranks):
                tier_store(self.states[k].rank(r), slots, rows)
        self.sync_host()
        obs.count("hot_warmed_rows", len(take))
        return len(take)

    def metrics(self) -> dict:
        out = {"hot_size": self.num_slots,
               "hot_hits": self.hot_hits,
               "hot_fast_path_hits": self.fast_path_hits}
        for k in range(self.num_layers):
            out[f"hot_valid_l{k + 1}"] = (
                float(self.valid[k].mean()) if self.num_slots else 0.0)
        return out

    def publish_ages(self) -> dict:
        """Publish this cache's replica ages (serving: no life-span)."""
        return publish_replica_ages(self.states)

    def reset_counters(self):
        self.hot_hits = 0
        self.fast_path_hits = 0

    def on_model_update(self):
        """Every replica is a function of the old parameters: drop them
        all (a dropped replica falls back to the normal fetch path)."""
        self._reset_states()
