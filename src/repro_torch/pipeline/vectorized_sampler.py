"""Vectorized CSR neighbor sampler (own numpy copy of
``repro/pipeline/vectorized_sampler.py``: ``_draw_neighbors``,
``sample_blocks_vectorized``, ``DeviceSampler``, ``concat_blocks`` and
``stack_ranks``).

Produces the fixed-shape ``MinibatchBlocks`` contract with no per-row
Python loops:

  * fanout draw: one uniform key matrix ``[n_dst, max_deg]`` per layer;
    the ``f`` smallest keys of a row are a uniform sample without
    replacement from that row's neighbors (rows with ``deg <= f`` keep all
    neighbors in CSR order).
  * relabeling: ``np.unique``/``np.setdiff1d`` for the new-leaf set and a
    direct lookup table instead of a Python dict.

The RNG consumption is the reference's, call for call, so the same
``np.random.default_rng([seed, mb])`` gives identical blocks in both
packages (``tests/test_torch_graph.py``).  With
``SamplerConfig.device_draw`` the fanout draw runs on the card instead
(:class:`DeviceSampler`, kernel I), seeded by the reference's ``fold_in``
chain, and the relabelling stays here on the host.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graph.partition import Partition
from repro_torch.graph.sampling import MinibatchBlocks, layer_capacities
from repro_torch.kernels.sample_draw import sample_draw
from repro_torch.pipeline.threefry import draw_seed


def _draw_neighbors(indptr: np.ndarray, indices: np.ndarray, cur: np.ndarray,
                    num_solid: int, f: int,
                    rng: np.random.Generator,
                    allow: Optional[np.ndarray] = None) -> np.ndarray:
    """Sampled neighbor VIDs ``[len(cur), f]`` (-1 pad), no Python loops.

    ``allow`` (bool ``[len(cur)]``) suppresses expansion of individual rows:
    a row with ``allow=False`` keeps an all ``-1`` neighbor list, exactly as
    a halo does.  The serving path uses this to turn cache-resident vertices
    into leaves — their embedding is substituted from the HEC, so their
    neighborhood never needs to be materialized.
    """
    n_dst = len(cur)
    out = np.full((n_dst, f), -1, np.int64)
    valid = (cur >= 0) & (cur < num_solid)        # halos are never expanded
    if allow is not None:
        valid &= allow
    vc = np.where(valid, cur, 0)
    deg = np.where(valid, indptr[vc + 1] - indptr[vc], 0)
    # compact to rows that actually sample: wide layers are mostly padding
    act = np.flatnonzero(deg > 0)
    if f <= 0 or len(act) == 0:
        return out
    deg = deg[act]
    starts = indptr[vc[act]]

    # deg <= f rows keep every neighbor (CSR order, left-packed) — no RNG
    small = deg <= f
    if small.any():
        ds, ss = deg[small], starts[small]
        w = int(ds.max())
        col = np.arange(w)
        in_row = col[None, :] < ds[:, None]
        gi = np.minimum(ss[:, None] + col[None, :], len(indices) - 1)
        out[act[small], :w] = np.where(in_row, indices[gi], -1)

    # deg > f rows: f smallest of iid uniform keys == uniform sample w/o
    # replacement; all f picks are in-row so no masking/packing needed.
    # Rows are processed in degree-sorted chunks so a few hub vertices don't
    # widen the key matrix (and the argpartition) for every row.
    big = ~small
    if big.any():
        rows, db, sb = act[big], deg[big], starts[big]
        order = np.argsort(db, kind="stable")
        for ch in np.array_split(order, min(8, len(order))):
            if not len(ch):
                continue
            d_ch = db[ch]
            w = int(d_ch.max())
            keys = rng.random((len(ch), w), dtype=np.float32)
            keys[np.arange(w)[None, :] >= d_ch[:, None]] = np.inf
            sel = np.argpartition(keys, f - 1, axis=1)[:, :f]
            out[rows[ch]] = indices[sb[ch][:, None] + sel]
    return out


def sample_blocks_vectorized(part: Partition, seeds_p: np.ndarray,
                             fanouts: Sequence[int],
                             rng: np.random.Generator,
                             batch_size: int,
                             expandable: Optional[Sequence[np.ndarray]]
                             = None,
                             draw_fn=None) -> MinibatchBlocks:
    """Fixed-shape blocks for ``seeds_p`` (uniform without replacement per
    row; the full row when ``deg <= fanout``).

    ``expandable`` (optional, length ``L+1``; entry ``k`` a bool array over
    VID_p — covering the solids, or solids + halos for sharded serving —
    or ``None``) gates neighborhood expansion per layer: a node at
    layer ``k`` with ``expandable[k][vid] == False`` is kept as a leaf —
    its layer-``k`` embedding is expected from a cache (serving) or the HEC
    (training halos), so its subtree is never sampled.  Entry 0 is unused
    (layer 0 is never expanded).

    ``draw_fn`` (optional) replaces the per-layer fanout draw:
    ``draw_fn(k, cur, f, allow) -> [len(cur), f]`` neighbor VID_p (-1
    pad), the contract of ``_draw_neighbors``; ``rng`` then draws nothing
    (:class:`DeviceSampler`).
    """
    fanouts = list(fanouts)
    L = len(fanouts)
    caps = layer_capacities(batch_size, fanouts)
    S = part.num_solid

    seeds = np.full(batch_size, -1, np.int64)
    seeds[:len(seeds_p)] = seeds_p
    seed_mask = seeds >= 0
    labels = np.zeros(batch_size, np.int64)
    labels[seed_mask] = part.labels[seeds[seed_mask]]

    layer_nodes: List[np.ndarray] = [None] * (L + 1)
    node_mask: List[np.ndarray] = [None] * (L + 1)
    nbr_idx: List[np.ndarray] = [None] * L
    layer_nodes[L] = seeds
    node_mask[L] = seed_mask

    cur = seeds
    for k in range(L - 1, -1, -1):              # seeds toward inputs
        f = fanouts[k]
        n_dst = len(cur)
        allow = None
        if expandable is not None and expandable[k + 1] is not None:
            # masks may cover solids only (single-partition serving) or
            # solids + halos (sharded serving); rows outside the mask are
            # halos or padding, which never expand regardless of `allow`
            m = expandable[k + 1]
            allow = m[np.where((cur >= 0) & (cur < len(m)), cur, 0)]
        if draw_fn is not None:
            nbrs = draw_fn(k, cur, f, allow)
        else:
            nbrs = _draw_neighbors(part.indptr, part.indices, cur, S, f,
                                   rng, allow=allow)

        # finer node list: dst prefix + sorted unique new neighbors
        flat = nbrs.ravel()
        nz = flat >= 0
        uniq = np.unique(flat[nz])
        cur_valid = cur[cur >= 0]
        extra = np.setdiff1d(uniq, cur_valid, assume_unique=True)
        cap = caps[k]
        n_fine = n_dst + len(extra)
        assert n_fine <= cap, (n_fine, cap)
        fine = np.full(cap, -1, np.int64)
        fine[:n_dst] = cur
        fine[n_dst:n_fine] = extra

        # VID_p -> position in `fine` via a direct lookup table (uninit'd is
        # fine: only positions of present VIDs are ever read back)
        vmask = fine >= 0
        fpos = np.flatnonzero(vmask)
        pos_of = np.empty(S + part.num_halo, np.int64)
        pos_of[fine[vmask]] = fpos
        positions = np.full(flat.shape, -1, np.int64)
        if nz.any():
            positions[nz] = pos_of[flat[nz]]

        nbr_idx[k] = positions.reshape(n_dst, f)
        layer_nodes[k] = fine
        node_mask[k] = vmask
        cur = fine

    return MinibatchBlocks(layer_nodes=layer_nodes, node_mask=node_mask,
                           nbr_idx=nbr_idx, seeds=seeds, seed_mask=seed_mask,
                           labels=labels)


class DeviceSampler:
    """The fanout draw of one partition on the card (kernel I), the
    reference's ``DeviceSampler``.

    The solid CSR is uploaded once, as int32; ``width`` is the
    partition's largest degree.  Draws are stateless: the seed of each is
    :func:`~repro_torch.pipeline.threefry.draw_seed` of (base_seed,
    epoch, step, rank, layer), so the draw is the reference's for any
    prefetch worker count.  ``set_residency`` installs the ``cv`` weight
    table ``1 + cv_boost * resident`` over VID_p.

    ``device=None`` means the card; ``device="cpu"`` runs the plain
    version.  On the card every upload, launch and copy back runs on the
    sampler's own stream, into pinned memory, and only that stream is
    waited for: a draw on a prefetch worker never queues behind the
    training step on the current stream.  A lock serialises the draws of
    several worker threads on the one stream."""

    def __init__(self, part: Partition, base_seed: int = 0, rank: int = 0,
                 policy: str = "uniform", cv_boost: float = 4.0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.base_seed = int(base_seed)
        self.rank = int(rank)
        self.policy = policy
        self.cv_boost = float(cv_boost)
        self.num_solid = part.num_solid
        deg = part.indptr[1:] - part.indptr[:-1]
        self.width = max(int(deg.max()) if part.num_solid else 0, 1)
        self._lock = threading.Lock()
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        with self._lock, self._on_stream():
            self._indptr = self._upload(part.indptr.astype(np.int32))
            self._indices = self._upload(part.indices.astype(np.int32))
            n_vids = part.num_solid + part.num_halo
            self._wtab = self._upload(np.ones(max(n_vids, 1), np.float32))
            self._sync()

    def _on_stream(self):
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self._stream is None:
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _sync(self):
        if self._stream is not None:
            self._stream.synchronize()

    def set_residency(self, resident: np.ndarray) -> None:
        """resident: bool [num_solid + num_halo] over VID_p, the vertices
        with a live HEC line; ``cv`` draws prefer them by ``1 +
        cv_boost``."""
        w = 1.0 + self.cv_boost * np.asarray(resident, np.float32)
        with self._lock, self._on_stream():
            self._wtab = self._upload(w.reshape(-1))
            self._sync()

    def seed(self, epoch: int, step: int, layer: int) -> int:
        return draw_seed(self.base_seed, epoch, step, self.rank, layer)

    def draw(self, epoch: int, step: int, layer: int, cur: np.ndarray,
             f: int, allow: Optional[np.ndarray] = None) -> np.ndarray:
        """The draw of ``_draw_neighbors`` on the card: [len(cur), f]
        VID_p, int64."""
        seed = self.seed(epoch, step, layer)
        with obs.span("kernel_sample_draw"), self._lock, self._on_stream():
            cur_d = self._upload(np.asarray(cur).astype(np.int32))
            allow_d = None if allow is None else self._upload(
                np.asarray(allow, bool))
            out = sample_draw(self._indptr, self._indices, self._wtab, cur_d,
                              seed, allow_d, f=int(f),
                              num_solid=self.num_solid, width=self.width,
                              policy=self.policy)
            if self._stream is not None:
                host = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=True)
                out = host.copy_(out, non_blocking=True)
            self._sync()
        return out.numpy().astype(np.int64)


def _segment_perms(n_seg: int, caps: Sequence[int]) -> List[np.ndarray]:
    """Per-layer node permutations fusing ``n_seg`` equal-capacity blocks
    while keeping each layer's dst nodes a prefix of the finer layer.

    ``perms[k][i * caps[k] + p]`` is the fused position of segment ``i``'s
    layer-``k`` node ``p``.  Layer L (seeds) is a plain concatenation;
    going finer, a dst node (``p < caps[k+1]``) goes wherever its coarser
    copy went, and the extras of all segments follow after every dst
    node."""
    L = len(caps) - 1
    perms: List[np.ndarray] = [None] * (L + 1)
    perms[L] = np.arange(n_seg * caps[L])
    for k in range(L - 1, -1, -1):
        i = np.repeat(np.arange(n_seg), caps[k])
        p = np.tile(np.arange(caps[k]), n_seg)
        dst = p < caps[k + 1]
        coarse = perms[k + 1][i * caps[k + 1] + np.minimum(p, caps[k + 1] - 1)]
        extra = caps[k] - caps[k + 1]
        perms[k] = np.where(
            dst, coarse,
            n_seg * caps[k + 1] + i * extra + (p - caps[k + 1]))
    return perms


def concat_blocks(mbs: Sequence[MinibatchBlocks]) -> MinibatchBlocks:
    """Fuse N equal-shape minibatches into ONE block-diagonal minibatch
    (round batching: N serve rounds run as one step, so each hidden
    layer's halo fetch is one collective pair).

    Per layer, node arrays are permuted so that every coarser layer is
    still a prefix of the finer one (what the forward relies on for
    ``h[:n_dst]``), and ``nbr_idx`` positions are remapped through the
    same permutation: the fused forward computes, row for row, what the N
    separate forwards would."""
    if len(mbs) == 1:
        return mbs[0]
    N = len(mbs)
    L = mbs[0].num_layers
    caps = [len(x) for x in mbs[0].layer_nodes]         # per-segment caps
    if not all([len(x) for x in m.layer_nodes] == caps for m in mbs):
        raise ValueError("concat_blocks needs minibatches of equal shape")
    perms = _segment_perms(N, caps)

    layer_nodes, node_mask, nbr_idx = [], [], []
    for k in range(L + 1):
        ln = np.concatenate([m.layer_nodes[k] for m in mbs])
        nm = np.concatenate([m.node_mask[k] for m in mbs])
        out_ln = np.empty_like(ln)
        out_nm = np.empty_like(nm)
        out_ln[perms[k]] = ln
        out_nm[perms[k]] = nm
        layer_nodes.append(out_ln)
        node_mask.append(out_nm)
    for k in range(L):
        # rows follow the (new) order of the coarser layer k+1; position
        # values are segment-local -> remap through layer k's permutation
        rows = np.concatenate(
            [np.where(m.nbr_idx[k] >= 0,
                      perms[k][i * caps[k]
                               + np.maximum(m.nbr_idx[k], 0)], -1)
             for i, m in enumerate(mbs)])
        out = np.empty_like(rows)
        out[perms[k + 1]] = rows
        nbr_idx.append(out)
    return MinibatchBlocks(
        layer_nodes=layer_nodes, node_mask=node_mask, nbr_idx=nbr_idx,
        seeds=np.concatenate([m.seeds for m in mbs]),
        seed_mask=np.concatenate([m.seed_mask for m in mbs]),
        labels=np.concatenate([m.labels for m in mbs]))


def stack_ranks(mbs: Sequence[MinibatchBlocks]) -> Dict:
    """Stack per-rank blocks into the host-side [R, ...] minibatch layout
    (numpy, so prefetch workers never touch the device)."""
    L = mbs[0].num_layers
    return {
        "seeds": np.stack([m.seeds for m in mbs]).astype(np.int32),
        "seed_mask": np.stack([m.seed_mask for m in mbs]),
        "labels": np.stack([m.labels for m in mbs]).astype(np.int32),
        "nbr_idx": [np.stack([m.nbr_idx[k] for m in mbs]).astype(np.int32)
                    for k in range(L)],
        "layer_nodes": [np.stack([m.layer_nodes[k] for m in mbs])
                        .astype(np.int32) for k in range(L + 1)],
        "node_mask": [np.stack([m.node_mask[k] for m in mbs])
                      for k in range(L + 1)],
    }
