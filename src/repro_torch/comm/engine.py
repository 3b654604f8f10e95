"""HaloExchangeEngine: the AEP push of training (own copy of the ``aep``
part of ``repro/comm/engine.py``; paper Algorithm 2, lines 8-9 and
14-24).

  * ``select_push`` (per rank): up to ``nc`` solid rows per remote rank,
    chosen from the static push contract (``push_mask``) by the largest
    of the given uniforms, and their per-layer embeddings.
  * ``push`` (all ranks): ONE fused all_to_all through the collective;
    the int32 tags ride bitcast into a flat prefix of the float32
    payload (``Tensor.view``), so the bits survive the collective.
  * ``aep_push``: select + push + append to each rank's delay queue.
  * ``consume_push`` (per rank): tick every layer's HEC, then store the
    queue's slot 0 — ``delay`` steps after it was pushed.

The reference draws the selection uniforms inside ``select_push`` from
``jax.random`` keyed on ``(7, seed, rank)``, which torch cannot
reproduce, so here they are an argument: the trainer passes the
reference's draws in the tests and a per-(step, rank) torch generator
otherwise.  The HEC states are updated in place.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from repro_torch.cache import hec as hec_lib
from repro_torch.comm.collective import StackedCollective
from repro_torch.core import aep


class HaloExchangeEngine:
    """The AEP push over a collective backend."""

    def __init__(self, num_ranks: int, num_layers: int, push_limit: int,
                 delay: int, comm: StackedCollective):
        self.num_ranks = num_ranks
        self.num_layers = num_layers
        self.push_limit = push_limit     # nc: slots per rank pair
        self.delay = delay               # d: steps between push and consume
        self.comm = comm

    def inflight_init(self, dim_max: int, device) -> List[dict]:
        """One ``[d, R, L, nc(, dmax)]`` in-flight queue per rank."""
        return [aep.queue_init(self.delay, self.num_ranks, self.num_layers,
                               self.push_limit, dim_max, device)
                for _ in range(self.num_ranks)]

    def select_push(self, push_mask: torch.Tensor, nodes0: torch.Tensor,
                    mask0: torch.Tensor, vid0: torch.Tensor,
                    num_solid: torch.Tensor, captured: Sequence,
                    u: torch.Tensor, dims: Sequence[int], dmax: int):
        """One rank's selection: ``push_mask [R_dst, P]``; the layer-0
        nodes (VID_p), mask and VID_o of the minibatch; ``captured[l] =
        (h_l, valid_l)`` detached forward activations; ``u [R, N0]``
        uniforms in (0, 1) -> (tags [R, L, nc] int32, embs [R, L, nc,
        dmax]).

        The ``nc`` largest scores are taken by a stable descending sort,
        so equal uniforms go to the lower position first, as
        ``lax.top_k`` does (``torch.topk`` does not promise an order among
        ties); the ``> 0`` mask then drops the non-member -1 scores."""
        R, L, nc = self.num_ranks, self.num_layers, self.push_limit
        dev = nodes0.device
        is_solid = (nodes0 < num_solid) & (nodes0 >= 0) & mask0
        P = push_mask.shape[1]
        member = push_mask[:, nodes0.clamp(0, P - 1).long()] \
            & is_solid[None, :]
        score = torch.where(member, u, torch.full((), -1.0, device=dev))
        topv, topi = torch.sort(score, dim=1, descending=True, stable=True)
        topv, topi = topv[:, :nc], topi[:, :nc]
        ok0 = topv > 0
        base_tags = torch.where(ok0, vid0[topi], -1)
        pos = torch.where(ok0, topi, 0)
        base_ok = base_tags >= 0
        tags = torch.zeros((R, L, nc), dtype=torch.int32, device=dev)
        embs = torch.zeros((R, L, nc, dmax), dtype=torch.float32, device=dev)
        for l in range(L):
            h_l, valid_l = captured[l]
            n_l = h_l.shape[0]
            p_cl = pos.clamp(0, n_l - 1)
            ok = base_ok & (pos < n_l) & valid_l[p_cl]
            embs[:, l, :, :dims[l]] = torch.where(ok[..., None], h_l[p_cl],
                                                  0.0)
            tags[:, l] = torch.where(ok, base_tags, -1)
        return tags, embs

    def push(self, tags: torch.Tensor, embs: torch.Tensor):
        """ONE fused all_to_all for all ranks: tags ``[R_src, R_dst, L,
        nc]`` int32 and embs ``[R_src, R_dst, L, nc, dmax]`` -> what each
        rank receives, ``(rec_tags [R_dst, R_src, L, nc], rec_embs [R_dst,
        R_src, L, nc, dmax])``."""
        R, _, L, nc = tags.shape
        dmax = embs.shape[-1]
        o = L * nc
        buf = torch.cat([tags.contiguous().view(torch.float32)
                         .reshape(R, R, o), embs.reshape(R, R, o * dmax)], -1)
        rec = self.comm.all_to_all(buf)
        rec_tags = rec[..., :o].contiguous().view(torch.int32) \
            .reshape(R, R, L, nc)
        return rec_tags, rec[..., o:].reshape(R, R, L, nc, dmax)

    def aep_push(self, selections: Sequence, inflight: List[dict],
                 dims: Sequence[int]):
        """Fused push of every rank's ``(tags, embs)`` selection, appended
        to each rank's queue.  Returns ``(inflight, stats)`` with the
        rows and bytes each rank sent (``[R]`` tensors)."""
        tags = torch.stack([t for t, _ in selections])
        embs = torch.stack([e for _, e in selections])
        sent = tags >= 0                                  # [R, R, L, nc]
        rows = sent.sum(dim=(1, 2, 3))
        nbytes = torch.zeros(self.num_ranks, dtype=torch.float32,
                             device=tags.device)
        for l in range(self.num_layers):
            nbytes += sent[:, :, l].sum(dim=(1, 2)).float() \
                * (4.0 + 4.0 * dims[l])
        rec_tags, rec_embs = self.push(tags, embs)
        inflight = [aep.queue_pop_push(q, rec_tags[r], rec_embs[r])
                    for r, q in enumerate(inflight)]
        return inflight, {"push_rows": rows, "push_bytes": nbytes}

    def consume_push(self, hec: Sequence[hec_lib.HECState], inflight: dict,
                     dims: Sequence[int], life_span: int):
        """One rank: tick every layer's HEC, then store the delay-expired
        push slot into it (in place)."""
        for st in hec:
            hec_lib.hec_tick(st, life_span)
        for l in range(self.num_layers):
            tl = inflight["tags"][0, :, l].reshape(-1)
            el = inflight["embs"][0, :, l, :, :dims[l]].reshape(-1, dims[l])
            hec_lib.hec_store(hec[l], tl, el)
