"""HaloExchangeEngine: every cross-rank embedding movement of the port
(own copy of ``repro/comm/engine.py``'s, over a collective backend).

The AEP push of training (paper Algorithm 2, lines 8-9 and 14-24):

  * ``select_push`` (per rank): up to ``nc`` solid rows per remote rank,
    chosen from the static push contract (``push_mask``) by the largest
    of the given uniforms, and their per-layer embeddings.
  * ``select_hot_push`` (per rank, with a hot budget): up to
    ``hot_budget`` of the hot vertices the rank owns, for the replicated
    hot tier; every rank receives the same rows.
  * ``push`` (all ranks): ONE fused all_to_all through the collective;
    the int32 tags ride bitcast into a flat prefix of the float32
    payload (``Tensor.view``), so the bits survive the collective; the hot
    segment, the same bytes to every destination, rides along.
  * ``aep_push``: push + append to each rank's delay queue.
  * ``filter_push`` (per rank, armed by the resilience plane): the
    reference's ``aep_push(fault_code=)`` path between a rank's selection
    and the push: non-finite payload rows are dropped (NaN containment),
    then the rank's scheduled wire fault applies.
  * ``consume_push`` (per rank): tick every layer's HEC (and hot-tier
    replica), then store the queue's slot 0 — ``delay`` steps after it
    was pushed.

The selection uniforms are an argument (the trainer draws the
reference's ``jax.random`` streams with ``pipeline/threefry.py``, or the
tests hand them in).  The HEC and tier states are updated in place.

The ``sync`` baseline: ``sync_fetch`` (all ranks) requests each rank's
first ``nc`` layer-0 halos from every rank; the owners answer from their
feature rows through the plan's sorted owner tables, in a second
all_to_all.

Serving:

  * ``cache_fetch`` (all ranks): one request/response all_to_all pair
    answering the halo rows a rank still needs at a hidden layer from
    their owners' layer-k caches — per owner the lowest ``need``
    positions up to the slot budget, the request all_to_all, the
    responders' probe (kernel J, one launch for every responder), the
    response all_to_all and the scatter back.
  * ``exchange_halos_host``: one exact halo exchange of distributed
    offline inference, through the plan's gather/scatter indices.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.cache import hec as hec_lib
from repro_torch.cache import hot_tier as hot_lib
from repro_torch.comm.collective import StackedCollective
from repro_torch.comm.plan import ExchangePlan, build_exchange_plan
from repro_torch.core import aep
from repro_torch.kernels.hec_search import hec_probe
from repro_torch.resilience.inject import CODE_CORRUPT_PUSH, CODE_DROP_PUSH


class HaloExchangeEngine:
    """Halo communication over a collective backend; built with
    :meth:`from_partition` it also carries the partition's
    :class:`ExchangePlan` (the offline exchange's indices)."""

    def __init__(self, num_ranks: int, num_layers: int = 1,
                 push_limit: int = 1, delay: int = 1,
                 comm: Optional[StackedCollective] = None,
                 plan: Optional[ExchangePlan] = None, hot_budget: int = 0):
        self.num_ranks = num_ranks
        self.num_layers = num_layers
        self.push_limit = push_limit     # nc (push) / slots (fetch) per pair
        self.delay = delay               # d: steps between push and consume
        self.comm = comm if comm is not None else StackedCollective(num_ranks)
        self.plan = plan
        self.hot_budget = hot_budget     # hot rows broadcast per rank per step
        self._plan_index = {}            # device -> offline exchange indices

    @classmethod
    def from_partition(cls, ps, num_layers: int = 1, push_limit: int = 1,
                       delay: int = 1,
                       comm: Optional[StackedCollective] = None):
        return cls(ps.num_parts, num_layers, push_limit, delay, comm,
                   plan=build_exchange_plan(ps))

    def inflight_init(self, dim_max: int, device) -> List[dict]:
        """One ``[d, R, L, nc(, dmax)]`` in-flight queue per rank; with a
        hot budget also ``hot_tags [d, R, L, hb]`` (tier slots, not vids)
        and ``hot_embs [d, R, L, hb, dmax]`` for the broadcast segment."""
        R, L, d = self.num_ranks, self.num_layers, self.delay
        queues = []
        for _ in range(R):
            q = aep.queue_init(d, R, L, self.push_limit, dim_max, device)
            if self.hot_budget:
                hb = self.hot_budget
                q["hot_tags"] = torch.full((d, R, L, hb), -1,
                                           dtype=torch.int32, device=device)
                q["hot_embs"] = torch.zeros((d, R, L, hb, dim_max),
                                            dtype=torch.float32,
                                            device=device)
            queues.append(q)
        return queues

    @staticmethod
    def _top(score: torch.Tensor, k: int):
        """The ``k`` largest scores along the last axis and their
        positions, equal scores lowest position first, as ``lax.top_k``
        gives them (``torch.topk`` does not promise an order among ties):
        a stable descending sort."""
        topv, topi = torch.sort(score, dim=-1, descending=True, stable=True)
        return topv[..., :k], topi[..., :k]

    def _rows(self, captured: Sequence, pos: torch.Tensor,
              base_tags: torch.Tensor, dims: Sequence[int], dmax: int):
        """The selected rows ``pos [..., k]`` at every layer: ``(tags
        [..., L, k] int32, embs [..., L, k, dmax])``; a row that is not in
        layer l's activations or not valid there is left out (-1, zeros)
        at that layer."""
        L = self.num_layers
        lead, k = tuple(pos.shape[:-1]), pos.shape[-1]
        dev = pos.device
        tags = torch.zeros(lead + (L, k), dtype=torch.int32, device=dev)
        embs = torch.zeros(lead + (L, k, dmax), dtype=torch.float32,
                           device=dev)
        base_ok = base_tags >= 0
        for l in range(L):
            h_l, valid_l = captured[l]
            n_l = h_l.shape[0]
            p_cl = pos.clamp(0, n_l - 1)
            ok = base_ok & (pos < n_l) & valid_l[p_cl]
            embs[..., l, :, :dims[l]] = torch.where(ok[..., None],
                                                    h_l[p_cl], 0.0)
            tags[..., l, :] = torch.where(ok, base_tags, -1)
        return tags, embs

    def select_push(self, push_mask: torch.Tensor, nodes0: torch.Tensor,
                    mask0: torch.Tensor, vid0: torch.Tensor,
                    num_solid: torch.Tensor, captured: Sequence,
                    u: torch.Tensor, dims: Sequence[int], dmax: int):
        """One rank's selection: ``push_mask [R_dst, P]``; the layer-0
        nodes (VID_p), mask and VID_o of the minibatch; ``captured[l] =
        (h_l, valid_l)`` detached forward activations; ``u [R, N0]``
        uniforms in (0, 1) -> (tags [R, L, nc] int32, embs [R, L, nc,
        dmax]).  The ``nc`` largest scores per destination are taken as
        ``lax.top_k`` takes them (:meth:`_top`); the ``> 0`` mask then
        drops the non-member -1 scores."""
        dev = nodes0.device
        is_solid = (nodes0 < num_solid) & (nodes0 >= 0) & mask0
        P = push_mask.shape[1]
        member = push_mask[:, nodes0.clamp(0, P - 1).long()] \
            & is_solid[None, :]
        score = torch.where(member, u, torch.full((), -1.0, device=dev))
        topv, topi = self._top(score, self.push_limit)
        ok0 = topv > 0
        return self._rows(captured, torch.where(ok0, topi, 0),
                          torch.where(ok0, vid0[topi], -1), dims, dmax)

    def select_hot_push(self, hot_vids: torch.Tensor, hot_mine: torch.Tensor,
                        nodes0: torch.Tensor, mask0: torch.Tensor,
                        vid0: torch.Tensor, num_solid: torch.Tensor,
                        captured: Sequence, u: torch.Tensor,
                        dims: Sequence[int], dmax: int):
        """One rank's hot-tier refresh: up to ``hot_budget`` of the hot
        vertices it owns (``hot_mine [K]``) among the minibatch's solid
        layer-0 rows, by the largest of ``u [N0]``.  Tags are the dense
        tier slots (positions in the sorted ``hot_vids [K]``), not vids ->
        (tags [L, hb] int32, embs [L, hb, dmax])."""
        is_solid = (nodes0 < num_solid) & (nodes0 >= 0) & mask0
        slot, is_hot = hot_lib.tier_slots(hot_vids, vid0)
        mine = hot_mine[slot] & is_hot & is_solid
        score = torch.where(mine, u, torch.full((), -1.0, device=u.device))
        topv, topi = self._top(score, self.hot_budget)
        ok0 = topv > 0
        return self._rows(captured, torch.where(ok0, topi, 0),
                          torch.where(ok0, slot[topi], -1), dims, dmax)

    @staticmethod
    def filter_push(sel, hot, code: int):
        """One rank's armed push (the reference's ``aep_push(fault_code=)``):
        ``sel = (tags [R, L, nc], embs [R, L, nc, dmax])`` and ``hot``
        (its hot segment, or ``None``) with every non-finite payload row
        dropped (tags -1, zeros): a locally poisoned step never reaches a
        remote HEC.  Then the host fault ``code``: ``CODE_CORRUPT_PUSH``
        turns the rows still tagged into NaN (the garbage lands in remote
        HEC lines), ``CODE_DROP_PUSH`` drops the whole payload (tags -1,
        zeros); the hot segment gets the filter only.  With ``code`` 0
        and finite rows the output is the input's bits."""
        tags, embs = sel
        ok = torch.isfinite(embs).all(dim=-1)
        tags = torch.where(ok, tags, -1)
        embs = torch.where(ok[..., None], embs, 0.0)
        if code & CODE_CORRUPT_PUSH:
            embs = torch.where((tags >= 0)[..., None], float("nan"), embs)
        if code & CODE_DROP_PUSH:
            tags = torch.full_like(tags, -1)
            embs = torch.zeros_like(embs)
        if hot is not None:
            h_tags, h_embs = hot
            h_ok = torch.isfinite(h_embs).all(dim=-1)
            hot = (torch.where(h_ok, h_tags, -1),
                   torch.where(h_ok[..., None], h_embs, 0.0))
        return (tags, embs), hot

    def push(self, tags: torch.Tensor, embs: torch.Tensor, hot=None):
        """ONE fused all_to_all for all ranks: tags ``[R_src, R_dst, L,
        nc]`` int32 and embs ``[R_src, R_dst, L, nc, dmax]`` -> what each
        rank receives, ``(rec_tags [R_dst, R_src, L, nc], rec_embs [R_dst,
        R_src, L, nc, dmax])``.  ``hot = (hot_tags [R_src, L, hb],
        hot_embs [R_src, L, hb, dmax])`` appends the broadcast segment, the
        same bytes to every destination, and adds ``(rec_hot_tags [R_dst,
        R_src, L, hb], rec_hot_embs [R_dst, R_src, L, hb, dmax])``."""
        R, _, L, nc = tags.shape
        dmax = embs.shape[-1]
        o = L * nc
        blocks = [tags.contiguous().view(torch.float32).reshape(R, R, o),
                  embs.reshape(R, R, o * dmax)]
        if hot is not None:
            hot_tags, hot_embs = hot
            hb = hot_tags.shape[-1]
            blocks.append(hot_tags.contiguous().view(torch.float32)
                          .reshape(R, 1, L * hb).expand(R, R, L * hb))
            blocks.append(hot_embs.reshape(R, 1, L * hb * dmax)
                          .expand(R, R, L * hb * dmax))
        rec = self.comm.all_to_all(torch.cat(blocks, -1))
        rec_tags = rec[..., :o].contiguous().view(torch.int32) \
            .reshape(R, R, L, nc)
        rec_embs = rec[..., o:o + o * dmax].reshape(R, R, L, nc, dmax)
        if hot is None:
            return rec_tags, rec_embs
        o += o * dmax
        rec_hot_tags = rec[..., o:o + L * hb].contiguous() \
            .view(torch.int32).reshape(R, R, L, hb)
        rec_hot_embs = rec[..., o + L * hb:].reshape(R, R, L, hb, dmax)
        return rec_tags, rec_embs, rec_hot_tags, rec_hot_embs

    def aep_push(self, selections: Sequence, inflight: List[dict],
                 dims: Sequence[int], hot: Optional[Sequence] = None):
        """Fused push of every rank's ``(tags, embs)`` selection (and, with
        ``hot``, of every rank's hot-tier segment), appended to each
        rank's queue.  Returns ``(inflight, stats)``: the rows and bytes
        each rank sent (``[R]`` tensors) and, with ``hot``, the hot rows
        it sent to the other ranks (``hot_push_rows``)."""
        R = self.num_ranks
        tags = torch.stack([t for t, _ in selections])
        embs = torch.stack([e for _, e in selections])
        sent = tags >= 0                                  # [R, R, L, nc]
        rows = sent.sum(dim=(1, 2, 3))
        nbytes = torch.zeros(R, dtype=torch.float32, device=tags.device)
        for l in range(self.num_layers):
            nbytes += sent[:, :, l].sum(dim=(1, 2)).float() \
                * (4.0 + 4.0 * dims[l])
        stats = {"push_rows": rows, "push_bytes": nbytes}
        if hot is None:
            rec_tags, rec_embs = self.push(tags, embs)
            inflight = [aep.queue_pop_push(q, rec_tags[r], rec_embs[r])
                        for r, q in enumerate(inflight)]
            return inflight, stats
        h_tags = torch.stack([t for t, _ in hot])           # [R, L, hb]
        h_embs = torch.stack([e for _, e in hot])
        h_sent = h_tags >= 0
        stats["hot_push_rows"] = h_sent.sum(dim=(1, 2)) * (R - 1)
        for l in range(self.num_layers):
            nbytes += h_sent[:, l].sum(dim=1).float() * (R - 1) \
                * (4.0 + 4.0 * dims[l])
        rec_tags, rec_embs, rec_ht, rec_he = self.push(
            tags, embs, hot=(h_tags, h_embs))
        out = []
        for r, q in enumerate(inflight):
            new = aep.queue_pop_push(q, rec_tags[r], rec_embs[r])
            new["hot_tags"] = torch.cat([q["hot_tags"][1:], rec_ht[r][None]])
            new["hot_embs"] = torch.cat([q["hot_embs"][1:], rec_he[r][None]])
            out.append(new)
        return out, stats

    def consume_push(self, hec: Sequence[hec_lib.HECState], inflight: dict,
                     dims: Sequence[int], life_span: int,
                     hot: Optional[Sequence] = None,
                     undo: Optional[list] = None):
        """One rank: tick every layer's HEC, then store the delay-expired
        push slot into it (in place); with ``hot`` (the rank's replica per
        layer) tick it and scatter the slot's hot segment into it.  A
        stale replica is rejected by the lookup, so its hub halo drops
        like an HEC miss.  ``undo`` journals the overwritten value rows
        (``hec.undo_stores``)."""
        for st in hec:
            hec_lib.hec_tick(st, life_span)
        for l in range(self.num_layers):
            tl = inflight["tags"][0, :, l].reshape(-1)
            el = inflight["embs"][0, :, l, :, :dims[l]].reshape(-1, dims[l])
            hec_lib.hec_store(hec[l], tl, el, undo=undo)
        if hot is None:
            return
        for l in range(self.num_layers):
            hot_lib.tier_tick(hot[l])
            sl = inflight["hot_tags"][0, :, l].reshape(-1)
            el = inflight["hot_embs"][0, :, l, :, :dims[l]].reshape(
                -1, dims[l])
            hot_lib.tier_store(hot[l], sl, el, undo=undo)

    # -- sync baseline fetch (all ranks) --------------------------------------
    def sync_fetch(self, sorted_vids: torch.Tensor, sorted_idx: torch.Tensor,
                   features: torch.Tensor, vid0: torch.Tensor,
                   is_halo0: torch.Tensor, h0: torch.Tensor):
        """DistDGL-like blocking fetch of fresh layer-0 halo features.

        Per rank (``vid0``/``is_halo0 [R, N0]``, ``h0 [R, N0, F]``) the
        first ``nc`` halos by position are requested from every rank; each
        owner finds them in its sorted owner table (``sorted_vids/idx [R,
        S]``, one ``searchsorted``) and answers its feature rows
        (``features [R, P, F]``) with an ok flag, in a second all_to_all;
        the answers are summed over ranks (one owner per vid) and added
        into ``h0``.  Returns ``(h0, got [R, N0])``, ``got`` the fetched
        halo rows.  Pure data movement: the rows are the owners' bits.
        Unused request slots (fewer halos than ``nc``) carry -1 and add
        zeros at position 0, as the reference's scatter does."""
        R, N0 = vid0.shape
        nc = self.push_limit
        dev = vid0.device
        prio = torch.arange(N0, 0, -1, dtype=torch.float32, device=dev)
        score = torch.where(is_halo0, prio, torch.full((), -1.0, device=dev))
        topv, topi = torch.topk(score, nc, dim=1)
        ok = topv > 0
        req_row = torch.where(ok, vid0.gather(1, topi), -1)     # [R, nc]
        pos_row = torch.where(ok, topi, 0)
        got_req = self.comm.all_to_all(
            req_row[:, None, :].expand(R, R, nc).contiguous())  # [R_o, R_s]
        flat = got_req.reshape(R, R * nc)
        S = sorted_vids.shape[1]
        loc = torch.searchsorted(sorted_vids, flat).clamp(0, S - 1)
        own = (sorted_vids.gather(1, loc) == flat) & (flat >= 0)
        ranks = torch.arange(R, device=dev)[:, None]
        feats = features[ranks, sorted_idx.gather(1, loc).long()] \
            * own[..., None]
        F = feats.shape[-1]
        resp = self.comm.all_to_all(torch.cat(
            [feats, own[..., None].to(feats.dtype)], -1).reshape(
                R, R, nc, F + 1))
        got_feats, got_ok = resp[..., :-1], resp[..., -1] > 0.5
        add = (got_feats * got_ok[..., None]).sum(1)        # [R_s, nc, F]
        any_ok = got_ok.any(1)                              # [R_s, nc]
        h0 = h0.scatter_add(1, pos_row[..., None].expand(R, nc, F),
                            torch.where(any_ok[..., None], add, 0.0))
        got = torch.zeros((R, N0), dtype=torch.int32, device=dev) \
            .scatter_reduce(1, pos_row, any_ok.int(), "amax") > 0
        return h0, got & is_halo0

    # -- serve-side cache fetch (all ranks) -----------------------------------
    def cache_fetch(self, state: hec_lib.HECState, vids_o: torch.Tensor,
                    owner: torch.Tensor, need: torch.Tensor, h: torch.Tensor,
                    slots: Optional[int] = None, rounds: int = 1,
                    alive: Optional[torch.Tensor] = None):
        """One request/response all_to_all pair answering every rank's
        ``need`` rows from their owners' layer-k caches.

        ``state`` is the layer's rank-stacked cache (``tags [R, nsets,
        ways]``); per rank ``vids_o``/``owner`` ``[R, N]`` (VID_o and owner
        rank of each row), ``need [R, N]`` bool and ``h [R, N, d]``.
        Returns ``(h, got [R, N], requested [R])``: ``h`` with the
        answered rows substituted, which rows were answered, and how many
        rows each rank requested.

        Per (requester, owner) the request takes the LOWEST ``need``
        positions owned there, in ascending order, up to ``nslots =
        min(slots * rounds, N)`` (``slots`` defaults to ``push_limit``) —
        the rows ``lax.top_k`` of descending priorities picks in the
        reference; rows past the budget drop.  ``rounds=N`` pools the
        budgets of N fused serve rounds.  Pad slots carry -1 and scatter
        to position N, where they drop.  ``alive [R]`` bool, if given,
        suppresses requests to a dead owner and makes a dead responder
        answer nothing; all-True computes the same as ``None``."""
        R = self.num_ranks
        N, d = h.shape[1], h.shape[2]
        dev = h.device
        nslots = min((slots or self.push_limit) * rounds, N)
        ranks = torch.arange(R, device=dev)
        want = need[:, None, :] & (owner[:, None, :] == ranks[None, :, None])
        if alive is not None:
            want = want & alive[None, :, None]
        # slot of each wanted row: its rank among the wanted rows of its
        # (requester, owner) pair; unwanted and over-budget rows go to a
        # trash column (nslots) that is cut off
        order = want.to(torch.int64).cumsum(-1) - 1
        take = want & (order < nslots)
        col = torch.where(take, order, nslots)
        req = torch.full((R, R, nslots + 1), -1, dtype=torch.int32,
                         device=dev)
        req.scatter_(2, col, torch.where(take, vids_o[:, None, :].to(
            torch.int32), -1))
        pos = torch.full((R, R, nslots + 1), N, dtype=torch.int64,
                         device=dev)
        pos.scatter_(2, col, torch.where(
            take, torch.arange(N, device=dev).expand(R, R, N), N))
        req = req[..., :nslots].contiguous()             # [R_s, R_j, nslots]
        pos = pos[..., :nslots]
        got_req = self.comm.all_to_all(req)              # [R_j, R_s, nslots]
        # every responder's probe in ONE launch, packed [values | ok]
        resp = self.comm.all_to_all(
            hec_probe(state.tags, state.values, got_req, alive))
        r_ok = resp[..., d] > 0.5                        # [R_s, R_j, nslots]
        r_vals = resp[..., :d] * r_ok[..., None]
        # rows requested from distinct owners occupy distinct positions;
        # every pad slot lands on column N, which is cut off
        flat = pos.reshape(R, R * nslots)
        fetched = torch.zeros((R, N + 1, d), dtype=h.dtype, device=dev)
        fetched.scatter_(1, flat[..., None].expand(R, R * nslots, d),
                         r_vals.reshape(R, R * nslots, d).to(h.dtype))
        got = torch.zeros((R, N + 1), dtype=torch.bool, device=dev)
        got.scatter_(1, flat, r_ok.reshape(R, R * nslots))
        got = got[:, :N]
        h = torch.where(got[..., None], fetched[:, :N], h)
        return h, got, (req >= 0).sum(dim=(1, 2))

    # -- exact offline exchange -----------------------------------------------
    def exchange_halos_host(self, h_solid: Sequence[torch.Tensor]) \
            -> Tuple[List[torch.Tensor], int]:
        """One exact halo exchange: every rank receives the current-layer
        embeddings of its halo replicas from their owners.  Pair (i, j)
        moves exactly ``db_halo(i, j)`` rows through the plan's gather and
        scatter indices (on the device of ``h_solid``).  Returns per-rank
        halo rows (aligned with ``part.halo_vids``) and the bytes moved
        (payload + 4-byte vid tags)."""
        if self.plan is None or self.plan.send_local is None:
            raise ValueError("needs an engine built with from_partition")
        plan = self.plan
        R = self.num_ranks
        dev = h_solid[0].device
        idx = self._plan_index.get(dev)
        if idx is None:
            t = lambda a: torch.as_tensor(a, dtype=torch.int64, device=dev)
            idx = self._plan_index[dev] = (
                [[t(a) for a in row] for row in plan.send_local],
                [[t(a) for a in row] for row in plan.recv_pos])
        send, recv = idx
        dim = h_solid[0].shape[1]
        rows_out: List[torch.Tensor] = []
        nbytes = 0
        rank_rows = np.zeros(R, np.int64)
        rank_bytes = np.zeros(R, np.int64)
        with obs.span("offline_exchange"):
            for j in range(R):
                rows = torch.zeros((int(plan.num_halo[j]), dim),
                                   dtype=torch.float32, device=dev)
                for i in range(R):
                    n = len(plan.send_local[i][j])
                    if i == j or not n:
                        continue
                    payload = h_solid[i][send[i][j]]
                    rows[recv[i][j]] = payload
                    moved = payload.numel() * payload.element_size() + n * 4
                    nbytes += moved
                    rank_rows[j] += n
                    rank_bytes[j] += moved
                rows_out.append(rows)
        obs.count("offline_exchange_bytes", nbytes)
        # the receivers' rows and bytes of this exchange, as rank series
        # (the live counterpart of ExchangePlan.expected_inbound_rows)
        reg = obs.get().registry
        if reg.enabled:
            obs.publish_rank_series(
                reg, {"rank_exchange_rows": rank_rows,
                      "rank_exchange_bytes": rank_bytes})
        return rows_out, nbytes
