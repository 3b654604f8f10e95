"""Plain PyTorch versions of the port's kernels.

Each function computes what its CUDA kernel computes, with torch ops.  The
kernel wrappers run them for tensors on the CPU, the CPU tests hold them
against the JAX reference, and ``chip_smoke.py`` holds each kernel
against its plain version on the card.  On the card they are a
correctness yardstick, not a speed one.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.gnn.common import (_MIX1, _MIX2, f32,
                                           gather_neighbors, hash_dropout,
                                           hash_uniform, masked_mean)

_MIX = 0x9E3779B1          # Fibonacci hashing multiplier of the HEC layout
_U32 = 0xFFFFFFFF
SAMPLE_POLICIES = ("uniform", "labor", "cv")


def fused_update_ref(agg: torch.Tensor, self_h: torch.Tensor,
                     wn: torch.Tensor, ws: torch.Tensor, b: torch.Tensor, *,
                     relu: bool = True, dropout: float = 0.0,
                     seed: int = 0) -> torch.Tensor:
    """UPDATE: ``dropout(relu(agg@Wn + self@Ws + b))`` with the position-
    hash dropout; ``repro.kernels.ref.fused_update_ref`` op for op.

    agg, self_h [N, C]; wn, ws [C, K]; b [K] -> [N, K]."""
    out = agg @ wn + self_h @ ws + b
    if relu:
        out = torch.relu(out)
    return hash_dropout(out, dropout, seed)


def fused_update_bwd_ref(g: torch.Tensor, out: torch.Tensor, *,
                         relu: bool = True, dropout: float = 0.0,
                         seed: int = 0):
    """Gradient of UPDATE w.r.t. its pre-activation ``Z = agg@Wn + self@Ws
    + b``: ``(dZ [N, K], db [K])`` from the output gradient ``g`` and the
    forward output ``out``.

    With ReLU, ``out > 0`` holds exactly where the position was kept and
    Z > 0 (relu's gradient is 0 at 0), so ``dZ = out > 0 ? g/(1-p) : 0``;
    without it the keep mask is drawn again from the hash.  No mask is
    stored.  ``db`` is the column sum of dZ."""
    if dropout > 0.0:
        if relu:
            keep = out > 0
        else:
            keep = hash_uniform(seed, torch.arange(g.shape[0], device=g.device),
                                torch.arange(g.shape[1], device=g.device)
                                ) >= f32(dropout, g)
        dz = torch.where(keep, g / f32(1.0 - dropout, g), f32(0.0, g))
    elif relu:
        dz = torch.where(out > 0, g, f32(0.0, g))
    else:
        dz = g
    return dz, dz.sum(dim=0)


def sage_agg_ref(h_src: torch.Tensor, nbr_idx: torch.Tensor,
                 src_valid: torch.Tensor):
    """AGG: the masked mean of ``h_src`` rows at ``nbr_idx`` (a -1 pad or
    an invalid source is excluded; a row with none gives 0) and the count
    of included neighbors: ``(mean [M, D], cnt [M] float32)``."""
    feats, mask = gather_neighbors(h_src, nbr_idx, src_valid)
    cnt = mask.sum(dim=1).to(torch.float32)
    return masked_mean(feats, mask), cnt


def sage_agg_bwd_ref(g: torch.Tensor, nbr_idx: torch.Tensor,
                     src_valid: torch.Tensor, cnt: torch.Tensor,
                     num_src: int) -> torch.Tensor:
    """Gradient of AGG w.r.t. ``h_src``: ``dh[nbr[i, j]] += g[i] /
    max(cnt[i], 1)`` over the included entries -> [num_src, D], as the
    reference's autodiff takes it: a masked entry adds ``0 * g[i]`` at its
    row (a -1 pad at row 0), NaN where ``g`` is not finite; an index past
    ``num_src`` reads row ``num_src - 1`` in the forward (jnp's gather
    clamps) but adds nothing here, not even that: the gather's gradient, a
    scatter, drops out-of-range indices."""
    idx = nbr_idx.long().clamp(0, max(num_src - 1, 0))
    mask = (nbr_idx >= 0) & (nbr_idx < num_src) & src_valid[idx]
    # masked entries add zeros, those past num_src go to a spare row that
    # is dropped: no boolean indexing, so no host sync
    rows = (g / cnt.clamp_min(1.0)[:, None])[:, None, :] \
        * mask[..., None].to(g.dtype)
    dh = torch.zeros((num_src + 1, g.shape[1]), dtype=g.dtype,
                     device=g.device)
    dh.index_add_(0, _scatter_rows(nbr_idx, num_src).reshape(-1),
                  rows.reshape(-1, g.shape[1]))
    return dh[:num_src]


def _scatter_rows(nbr_idx: torch.Tensor, num_src: int) -> torch.Tensor:
    """Where a gradient scatters each slot (int64): its row, 0 for a -1
    pad, and the spare row ``num_src`` (dropped after the scatter) for an
    index past the last row, which jnp's scatter drops."""
    return torch.where(nbr_idx >= num_src, num_src,
                       nbr_idx.long().clamp_min(0))


def serve_layer_ref(h_src: torch.Tensor, nbr_idx: torch.Tensor,
                    src_valid: torch.Tensor, wn: torch.Tensor,
                    ws: torch.Tensor, b: torch.Tensor, *, relu: bool = True,
                    self_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One serve layer: gather + masked mean + ``agg@Wn + self@Ws + b``
    (+ReLU); ``repro.kernels.ref.serve_layer_ref`` op for op.

    h_src [N, D]; nbr_idx [M, f] (-1 pad); src_valid [N] bool;
    wn/ws [D, K]; b [K]; self_idx [M] (default: the ``h_src[:M]`` prefix,
    clamped to ``[0, N)`` like the reference's ``jnp.clip``) -> [M, K].
    """
    feats, mask = gather_neighbors(h_src, nbr_idx, src_valid)
    agg = masked_mean(feats, mask)
    M = nbr_idx.shape[0]
    if self_idx is None:
        self_h = h_src[:M]
    else:
        self_h = h_src[self_idx.long().clamp(0, h_src.shape[0] - 1)]
    out = agg @ wn + self_h @ ws + b
    return torch.relu(out) if relu else out


def set_index(vids: torch.Tensor, nsets: int) -> torch.Tensor:
    """VID -> HEC set: ``((u32)vid * 0x9E3779B1 >> 8) % nsets`` (int64).

    u32 arithmetic emulated in int64, since torch has no uint32 shift or
    remainder on the CPU: a negative vid is first taken mod 2^32, as the
    reference's ``astype(uint32)`` does, and the product is formed from
    16-bit halves so that no intermediate leaves int64."""
    v = vids.long() & _U32
    lo, hi = v & 0xFFFF, v >> 16
    prod = (lo * _MIX + (((hi * _MIX) & 0xFFFF) << 16)) & _U32
    return (prod >> 8) % nsets


def hec_lookup_ref(tags: torch.Tensor, values: torch.Tensor,
                   vids: torch.Tensor):
    """HECSearch + HECLoad: vids [n] -> (hit [n] bool, set [n] int32,
    way [n] int32, emb [n, d] with misses zeroed).

    ``way`` is the first way whose tag equals the vid (0 if none); a
    negative vid never hits.  Same outputs as the reference's
    ``hec_search_kernel`` followed by ``hec_load`` and the miss mask."""
    nsets = tags.shape[0]
    s = set_index(vids, nsets)
    match = tags[s] == vids[:, None].to(tags.dtype)
    hit = match.any(dim=1) & (vids >= 0)
    way = match.to(torch.int32).argmax(dim=1)
    emb = torch.where(hit[:, None], values[s, way],
                      torch.zeros((), dtype=values.dtype,
                                  device=values.device))
    return hit, s.to(torch.int32), way.to(torch.int32), emb


def hec_probe_ref(tags: torch.Tensor, values: torch.Tensor,
                  vids: torch.Tensor,
                  alive: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched HECSearch + HECLoad of R stacked responder caches, packed as
    the response buffer of a serve-side cache fetch: ``tags [R, nsets,
    ways]``, ``values [R, nsets, ways, d]``, ``vids [R, B, n]`` ->
    ``[R, B, n, d + 1]`` float32.  Columns ``:d`` are responder r's
    ``hec_lookup_ref`` row of each vid (zeros on a miss), column ``d`` is
    1.0 where it hit and ``alive[r]`` holds (a dead responder answers
    nothing), else 0.0: the reference's ``hec_probe`` followed by its
    concatenate of the values and the ok flag."""
    R, B, n = vids.shape
    d = values.shape[-1]
    rows = []
    for r in range(R):
        hit, _, _, emb = hec_lookup_ref(tags[r], values[r],
                                        vids[r].reshape(-1))
        ok = hit if alive is None else hit & alive[r]
        rows.append(torch.cat([emb, ok[:, None].to(emb.dtype)], 1)
                    .reshape(B, n, d + 1))
    if not rows:
        return torch.zeros((0, B, n, d + 1), dtype=values.dtype,
                           device=values.device)
    return torch.stack(rows)


def _slot_blocks(M: int, f: int, width: int, limit: int = 1 << 28):
    """Slices of the fanout such that a gathered ``[M, block, width]``
    tensor holds at most ``limit`` elements (at least one slot each): few
    torch ops per call, and no multi-GB tensor at training layer 0."""
    step = max(1, limit // max(M * width, 1))
    for j0 in range(0, f, step):
        yield slice(j0, min(j0 + step, f))


def _gat_alpha(e_u: torch.Tensor, e_v: torch.Tensor, nbr_idx: torch.Tensor,
               src_valid: torch.Tensor,
               dst_idx: Optional[torch.Tensor] = None):
    """The edge softmax of GAT AGG: ``(alpha [M, f, H], s [M, f, H], idx
    [M, f] int64)``, ``s = e_u[nbr] + e_v[dst]`` before the LeakyReLU.
    ``idx`` is ``nbr_idx`` clamped to ``[0, N)``, as jnp's gather clamps; a
    slot counts when it is not a -1 pad and its source is valid.  The
    softmax is the Pallas kernel's: masked slots at -1e30, the max over
    the fanout subtracted, masked slots zeroed after the exp, the sum
    floored at 1e-20 (a row with no slot gives zeros); a masked slot's
    alpha is 0 even where the sum is NaN, as the reference's
    ``where(mask, alpha, 0)`` makes it."""
    M = nbr_idx.shape[0]
    idx = nbr_idx.long().clamp(0, max(e_u.shape[0] - 1, 0))
    mask = (nbr_idx >= 0) & src_valid[idx]
    if dst_idx is None:
        ev = e_v[:M]
    else:
        ev = e_v[dst_idx.long().clamp(0, e_v.shape[0] - 1)]
    s = e_u[idx] + ev[:, None, :]
    m3 = mask[..., None]
    neg = torch.full((), -1e30, dtype=s.dtype, device=s.device)
    lrelu = torch.where(s >= 0, s, 0.2 * s)
    scores = torch.where(m3, lrelu, neg)
    p = torch.exp(scores - scores.amax(dim=1, keepdim=True))
    p = torch.where(m3, p, torch.zeros((), dtype=s.dtype, device=s.device))
    alpha = torch.where(m3, p / p.sum(dim=1, keepdim=True).clamp_min(1e-20),
                        torch.zeros((), dtype=s.dtype, device=s.device))
    return alpha, s, idx


def gat_edge_ref(z: torch.Tensor, e_u: torch.Tensor, e_v: torch.Tensor,
                 nbr_idx: torch.Tensor, src_valid: torch.Tensor,
                 dst_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GAT AGG (paper eq. 2): LeakyReLU(0.2) of ``e_u[nbr] + e_v[dst]``, a
    masked softmax over the fanout per head, then ``out[m, h, :] = sum_f
    alpha[m, f, h] z[nbr[m, f], h, :]``; ``repro.kernels.ref.gat_edge_ref``
    and the Pallas ``gat_edge`` behind ``ops.gat_edge_aggregate``.

    z [N, H, dh]; e_u [N, H]; e_v [N_ev, H]; nbr_idx [M, f] (-1 pad);
    src_valid [N] bool; dst_idx [M] (default: row m reads ``e_v[m]``;
    else ``e_v[clip(dst_idx)]``, the offline engine's ``_gat_chunk``)
    -> [M, H * dh].  The gathered neighbor rows are made in blocks of
    slots (:func:`_slot_blocks`), never as one ``[M, f, H, dh]`` tensor
    when that would be large."""
    alpha, _, idx = _gat_alpha(e_u, e_v, nbr_idx, src_valid, dst_idx)
    M, f = nbr_idx.shape
    out = torch.zeros((M,) + tuple(z.shape[1:]), dtype=z.dtype,
                      device=z.device)
    for js in _slot_blocks(M, f, z.shape[1] * z.shape[2]):
        out = out + torch.einsum("mjh,mjhe->mhe", alpha[:, js], z[idx[:, js]])
    return out.reshape(M, -1)


def gat_edge_bwd_ref(g: torch.Tensor, z: torch.Tensor, e_u: torch.Tensor,
                     e_v: torch.Tensor, nbr_idx: torch.Tensor,
                     src_valid: torch.Tensor,
                     dst_idx: Optional[torch.Tensor] = None):
    """Gradient of :func:`gat_edge_ref` from ``g = dL/dout [M, H * dh]``:
    ``(dz [N, H, dh], de_u [N, H], de_v [N_ev, H])``, as the reference's
    autodiff takes it.

    ``da[m,f,h] = <g[m,h,:], z[nbr,h,:]>``, 0 at masked slots (the
    reference masks alpha by a select, whose gradient there is 0); the
    softmax's ``dl = alpha * (da - sum_f alpha * da)``; ``ds = dl`` where
    ``s >= 0`` else ``0.2 dl`` (LeakyReLU's gradient is 1 at 0, as
    ``jax.nn.leaky_relu``'s), 0 at masked slots (the scores' select);
    then ``de_u[nbr] += ds``, ``dz[nbr] += alpha g`` (so a masked slot
    adds ``0 * g``, NaN where ``g`` is not finite) and ``de_v[dst] +=
    sum_f ds``.  A slot whose index is past ``N`` reads row ``N - 1`` in
    the forward but scatters nothing into ``dz`` and ``de_u``: jnp's
    gather clamps, its gradient (a scatter) drops out-of-range indices."""
    alpha, s, idx = _gat_alpha(e_u, e_v, nbr_idx, src_valid, dst_idx)
    M, f = nbr_idx.shape
    N, H, dh = z.shape
    g3 = g.reshape(M, H, dh)
    m3 = ((nbr_idx >= 0) & src_valid[idx])[..., None]
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    blocks = list(_slot_blocks(M, f, H * dh))
    da = torch.cat([torch.einsum("mhe,mjhe->mjh", g3, z[idx[:, js]])
                    for js in blocks], 1) if f else alpha
    da = torch.where(m3, da, zero)
    dl = alpha * (da - (alpha * da).sum(dim=1, keepdim=True))
    ds = torch.where(m3, torch.where(s >= 0, dl, 0.2 * dl), zero)
    # slots past N go to a spare row that is dropped (jnp's scatter)
    rows = _scatter_rows(nbr_idx, N)
    de_u = torch.zeros((N + 1, H), dtype=g.dtype, device=g.device)
    de_u.index_add_(0, rows.reshape(-1), ds.reshape(-1, H))
    de_u = de_u[:N]
    dz = torch.zeros((N + 1, H, dh), dtype=g.dtype, device=g.device)
    for js in blocks:
        dz.index_add_(0, rows[:, js].reshape(-1),
                      (alpha[:, js, :, None] * g3[:, None]).reshape(-1, H,
                                                                    dh))
    dz = dz[:N]
    de_v = torch.zeros((e_v.shape[0], H), dtype=g.dtype, device=g.device)
    dsum = ds.sum(dim=1)
    if dst_idx is None:
        de_v[:M] = dsum
    else:
        de_v.index_add_(0, dst_idx.long().clamp(0, e_v.shape[0] - 1), dsum)
    return dz, de_u, de_v


def _hash_u01(a: torch.Tensor, b: torch.Tensor, seed: int) -> torch.Tensor:
    """The u32 mix hash of ``hash_uniform`` on elementwise operands ``a``,
    ``b`` (int64 tensors holding u32 values) -> float32 in [0, 1)."""
    h = ((a * _MIX1) & _U32) ^ ((b * _MIX2) & _U32) ^ (int(seed) & _U32)
    h = h ^ (h >> 15)
    h = h * _MIX1 & _U32
    h = h ^ (h >> 13)
    return (h >> 8).to(torch.float32) / float(1 << 24)


def sample_keys(seed: int, nbr_vid: torch.Tensor,
                weights: Optional[torch.Tensor] = None, *,
                policy: str = "uniform",
                rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Selection keys of the fanout draw, the f smallest of a row win;
    ``repro.kernels.ref.sample_keys_ref`` (and the Pallas
    ``sample_keys_kernel``) bit for bit.

    nbr_vid [n, W] candidate VIDs (-1 = no candidate); weights [n, W]
    float32 (``cv`` only); ``rows`` [n] the rows' positions in the draw
    (default ``0..n-1``; ``uniform`` hashes them).  Returns [n, W]
    float32, +inf where ``nbr_vid`` is -1:

      uniform  hash(row, slot)
      labor    hash(vid, 0)
      cv       hash(vid, 0) / max(weight, 1e-6), an IEEE float32 division

    u32 arithmetic is emulated in int64, as in ``hash_uniform``."""
    if policy not in SAMPLE_POLICIES:
        raise ValueError(f"unknown sample policy: {policy!r}")
    n, w = nbr_vid.shape
    dev = nbr_vid.device
    if policy == "uniform":
        if rows is None:
            rows = torch.arange(n, device=dev)
        keys = _hash_u01(rows.long()[:, None] & _U32,
                         torch.arange(w, device=dev)[None, :], seed)
    else:
        vid = nbr_vid.long().clamp_min(0) & _U32
        keys = _hash_u01(vid, torch.zeros_like(vid), seed)
        if policy == "cv":
            keys = keys / weights.to(torch.float32).clamp_min(1e-6)
    return torch.where(nbr_vid >= 0, keys,
                       torch.full((), float("inf"), device=dev))


def draw_neighbors(indptr: torch.Tensor, indices: torch.Tensor,
                   wtab: torch.Tensor, cur: torch.Tensor, seed: int,
                   allow: Optional[torch.Tensor], *, f: int, num_solid: int,
                   width: int, policy: str = "uniform",
                   limit: int = 1 << 24) -> torch.Tensor:
    """The fanout draw of kernel I: ``cur`` [n] frontier VID_p -> [n, f]
    int32 neighbor VID_p (-1 pad); ``repro.kernels.sample_draw.
    draw_neighbors_device`` bit for bit.

    indptr [S+1], indices [E] the solid CSR; wtab [S+H] float32 per-VID_p
    weights (``cv``); allow [n] bool or None; ``width`` the CSR's largest
    degree.  A row that is -1, a halo (``>= num_solid``) or not allowed
    draws nothing; a row with ``deg <= f`` takes its whole CSR range in
    order; a larger row keeps the f candidates with the smallest
    :func:`sample_keys`, in ``lax.top_k``'s order (ascending key, the
    lower slot first on equal keys, as under ``labor`` when a vertex
    appears twice in a row).  The larger rows are expanded to a dense
    candidate matrix ``width`` wide in blocks of at most ``limit``
    elements, and each block's f smallest are taken over the packed
    ``(key bits << 32) | slot``: keys are non-negative, so their bits
    order as the floats do, and no two packed values are equal."""
    n = cur.shape[0]
    dev = cur.device
    cur = cur.long()
    valid = (cur >= 0) & (cur < num_solid)
    if allow is not None:
        valid = valid & allow.bool()
    vc = torch.where(valid, cur, torch.zeros((), dtype=torch.long,
                                             device=dev))
    start = indptr[vc].long()
    deg = torch.where(valid, indptr[vc + 1].long() - start,
                      torch.zeros((), dtype=torch.long, device=dev))
    num_edges = indices.shape[0]
    if num_edges == 0 or f <= 0:
        return torch.full((n, max(f, 0)), -1, dtype=torch.int32, device=dev)
    col = torch.arange(f, device=dev)
    gi = (start[:, None] + col[None, :]).clamp_max(num_edges - 1)
    out = torch.where(col[None, :] < deg[:, None], indices[gi].long(),
                      torch.full((), -1, dtype=torch.long, device=dev))
    big = torch.nonzero(deg > f).flatten()
    if big.numel():
        wcol = torch.arange(width, device=dev)
        block = max(1, limit // max(width, 1))
        for b0 in range(0, big.numel(), block):
            rows = big[b0:b0 + block]
            in_row = wcol[None, :] < deg[rows][:, None]
            gi = (start[rows][:, None] + wcol[None, :]).clamp_max(
                num_edges - 1)
            nbr = torch.where(in_row, indices[gi].long(),
                              torch.full((), -1, dtype=torch.long,
                                         device=dev))
            w = wtab[nbr.clamp_min(0)] if policy == "cv" else None
            keys = sample_keys(seed, nbr, w, policy=policy, rows=rows)
            packed = (keys.view(torch.int32).long() << 32) | wcol[None, :]
            sel = torch.topk(packed, f, dim=1, largest=False,
                             sorted=True).indices
            out[rows] = torch.gather(nbr, 1, sel)
    return out.to(torch.int32)
