"""Inputs with infinite, NaN and near-``FLT_MAX`` values at every kind of
slot, made with numpy from a seed: what holds kernels C, A, F and H to
their plain versions where the values are not finite (the card's tests
and ``chip_smoke.py``), and the plain versions to the reference (the CPU
tests).

* :func:`agg_case` (F): a gradient ``g`` with non-finite rows at a row of
  pads only, a row of masked sources only, a row whose slots are all past
  the last source row, a row with kept and masked slots, and one element.
* :func:`gat_case` (H): the same neighbor lists and, by ``kind``, a
  non-finite ``g`` (``"g"``), NaN and inf rows of ``z`` at masked, padded
  and kept sources (``"z"``), or a NaN ``e_u`` row of a kept source, which
  makes its rows' softmax NaN (``"eu"``).
* :func:`update_case` (C) and :func:`serve_case` (A): infinite inputs, and
  finite ones whose TF32 part rounds to infinity, beside weights that
  make some products overflow and some multiply an infinity by 0.
"""
from __future__ import annotations

import numpy as np

NEAR_MAX = np.float32(3.4027e38)     # its TF32 part rounds up to +inf
GAT_KINDS = ("g", "z", "eu")


def _need(ok: bool, what: str):
    if not ok:
        raise ValueError(f"a non-finite case needs {what}")


def _neighbors(rng, N: int, M: int, f: int):
    """``(nbr [M, f] int32, valid [N] bool)``: -1 pads and indices past
    N anywhere; row 0 all pads, row 1 only masked sources, row 2 only
    indices past N, row 3 a kept slot first."""
    valid = rng.random(N) > 0.2
    valid[:2] = True                     # row 0 (the pads' row) is kept
    valid[N // 2:N // 2 + 3] = False     # three masked sources at least
    nbr = rng.integers(-1, N + 3, (M, f)).astype(np.int32)
    masked = np.flatnonzero(~valid)
    nbr[0] = -1
    nbr[1] = masked[rng.integers(0, len(masked), f)]
    nbr[1, 0] = masked[0]
    nbr[2] = N + np.arange(f) % 3
    nbr[3, 0] = np.flatnonzero(valid)[3]
    return nbr, valid


def agg_case(seed: int, N: int, M: int, f: int, D: int) -> dict:
    """Kernel F's operands: ``g [M, D]``, ``nbr_idx``, ``src_valid`` and
    the forward's count ``cnt [M]`` (float32)."""
    _need(M >= 6 and N >= 10 and D >= 6, "M >= 6, N >= 10, D >= 6")
    rng = np.random.default_rng(seed)
    nbr, valid = _neighbors(rng, N, M, f)
    g = rng.normal(size=(M, D)).astype(np.float32)
    g[0] = np.nan                        # pads only: NaN at row 0
    g[1, :3] = np.inf                    # masked sources only
    g[2] = -np.inf                       # past N only: adds nothing
    g[3, 5] = np.nan                     # kept and masked slots
    g[4] = np.inf
    g[5, 1] = -np.inf
    idx = np.clip(nbr, 0, N - 1)
    cnt = ((nbr >= 0) & valid[idx]).sum(1).astype(np.float32)
    return dict(g=g, nbr_idx=nbr, src_valid=valid, cnt=cnt)


def gat_case(seed: int, N: int, M: int, f: int, H: int, dh: int,
             kind: str) -> dict:
    """Kernel H's operands ``g [M, H * dh]``, ``z [N, H, dh]``, ``e_u
    [N, H]``, ``e_v [N, H]``, ``nbr_idx``, ``src_valid``, non-finite as
    ``kind`` says (:data:`GAT_KINDS`)."""
    _need(M >= 6 and N >= 10 and H * dh >= 3 and kind in GAT_KINDS,
          f"M >= 6, N >= 10, H * dh >= 3, kind in {GAT_KINDS}")
    rng = np.random.default_rng(seed)
    nbr, valid = _neighbors(rng, N, M, f)
    z = rng.normal(size=(N, H, dh)).astype(np.float32)
    eu = rng.normal(size=(N, H)).astype(np.float32)
    ev = rng.normal(size=(N, H)).astype(np.float32)
    g = rng.normal(size=(M, H * dh)).astype(np.float32)
    if kind == "g":
        g[0] = np.nan
        g[1, :3] = np.inf
        g[2] = -np.inf
        g[3, -1] = np.nan
        g[4] = np.inf
    elif kind == "z":
        masked, kept = np.flatnonzero(~valid), np.flatnonzero(valid)
        z[masked[:3]] = np.nan
        z[0, 0, 0] = np.inf              # the pads' row
        z[kept[5]] = np.nan
        z[kept[6], -1, -1] = -np.inf
    else:
        eu[np.flatnonzero(valid)[3], 0] = np.nan
    return dict(g=g, z=z, e_u=eu, e_v=ev, nbr_idx=nbr, src_valid=valid)


def update_case(seed: int, N: int, C: int, K: int) -> dict:
    """Kernel C's operands ``agg, self_h [N, C]``, ``wn, ws [C, K]``,
    ``b [K]``: +-inf inputs, a near-``FLT_MAX`` input under a weight
    row of 0.5s and 2s (finite and overflowing products) and under a row
    of zeros, an inf under a weight of 0 (NaN), and a NaN."""
    _need(N >= 6 and C >= 4 and K >= 8, "N >= 6, C >= 4, K >= 8")
    rng = np.random.default_rng(seed)
    agg = rng.normal(size=(N, C)).astype(np.float32)
    self_h = rng.normal(size=(N, C)).astype(np.float32)
    wn = (rng.normal(size=(C, K)) * 0.1).astype(np.float32)
    ws = (rng.normal(size=(C, K)) * 0.1).astype(np.float32)
    b = (rng.normal(size=K) * 0.1).astype(np.float32)
    agg[0, 3] = np.inf
    self_h[1, 0] = -np.inf
    agg[2, 1] = NEAR_MAX
    wn[1] = np.where(np.arange(K) % 3 == 0, 2.0, 0.5) \
        * np.where(np.arange(K) % 2 == 0, 1.0, -1.0)
    self_h[3, 2] = -NEAR_MAX
    ws[2] = 0.0
    agg[4, 0] = np.inf
    wn[0, 7] = 0.0
    agg[5, 2] = np.nan
    return dict(agg=agg, self_h=self_h, wn=wn, ws=ws, b=b)


def serve_case(seed: int, N: int, M: int, f: int, D: int, K: int) -> dict:
    """Kernel A's operands ``h_src [N, D]``, ``nbr_idx``, ``src_valid``,
    ``wn, ws [D, K]``, ``b [K]``: an inf and a near-``FLT_MAX`` row at
    kept sources, an inf row at a masked source, the pads' row 0 near
    ``FLT_MAX`` (times 0 it is 0), overflowing weights."""
    _need(N >= 40 and M >= 6 and D >= 4 and K >= 8,
          "N >= 40, M >= 6, D >= 4, K >= 8")
    rng = np.random.default_rng(seed)
    nbr, valid = _neighbors(rng, N, M, f)
    h = rng.normal(size=(N, D)).astype(np.float32)
    kept, masked = np.flatnonzero(valid), np.flatnonzero(~valid)
    h[kept[3], 0] = np.inf
    h[kept[7], 1] = -NEAR_MAX
    h[masked[0], 2] = np.inf
    h[0, 3] = NEAR_MAX
    wn = (rng.normal(size=(D, K)) * 0.1).astype(np.float32)
    ws = (rng.normal(size=(D, K)) * 0.1).astype(np.float32)
    wn[1, ::4] = 2.0
    ws[0, 5] = 0.0
    b = (rng.normal(size=K) * 0.1).astype(np.float32)
    return dict(h_src=h, nbr_idx=nbr, src_valid=valid, wn=wn, ws=ws, b=b)
