"""xLSTM blocks [arXiv:2405.04517]: mLSTM (matrix memory) and sLSTM (scalar)
(port of ``repro/models/transformer/xlstm.py``).

True mLSTM semantics (per head, q/k/v in R^dh):
    C*_t = sum_{s<=t} exp(g_t - g_s + logi_s) k_s v_s^T,   g_t = cumsum(logf)
    n*_t analogous with k_s;   h_t = (q_t @ C*_t) / max(|n*_t . q_t|, 1)
with logf = log_sigmoid(f_raw), logi = i_raw.  Both forms below compute
exactly this (stabilizer conventions cancel in the final ratio):

* ``mlstm_sequential`` — a loop over time (the oracle; also the decode step)
* ``mlstm_chunkwise``  — chunked-parallel: intra-chunk attention-like
  products + inter-chunk recurrence on (C, n, m); the block's prefill form.

sLSTM is inherently sequential (recurrent gate connections): a loop over
time.  Also the norms and the causal depthwise conv1d the recurrent blocks
share.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def weak_scalar(c: float, dtype: torch.dtype) -> float:
    """A Python scalar as jax applies it to an array of ``dtype``: rounded
    to that dtype first (a weakly typed constant)."""
    return float(torch.tensor(c, dtype=dtype))


def mul_weak(x: torch.Tensor, c: float) -> torch.Tensor:
    return x * weak_scalar(c, x.dtype)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``: XLA's logistic, which it expands to 1 / (1 +
    exp(-x)), each op rounded to x's dtype.  In bfloat16 a third of the
    outputs differ from a sigmoid rounded once, so that form is kept; in
    float32 the two differ by an ulp and torch's one kernel is used."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return torch.reciprocal(1 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * sigmoid(x) (:func:`sigmoid`)."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * sigmoid(x)


# ---------------------------------------------------------------------------
# mLSTM cell math
# ---------------------------------------------------------------------------
def mlstm_sequential(q, k, v, i_raw, f_raw, state=None):
    """q,k,v: [B,T,H,dh]; i_raw,f_raw: [B,T,H]. Returns (h [B,T,H,dh], state).

    state = (C [B,H,dh,dh], n [B,H,dh], m [B,H]) in "stabilized" units.
    """
    B, T, H, dh = q.shape
    if state is None:
        state = init_mlstm_state(B, H, dh, device=q.device)
    C, n, m = state
    q = mul_weak(q, dh ** -0.5)
    logf = F.logsigmoid(f_raw.float())
    logi = i_raw.float()
    qf, kf, vf = q.float(), k.float(), v.float()
    hs = []
    for t in range(T):
        qt, kt, vt, lit, lft = qf[:, t], kf[:, t], vf[:, t], logi[:, t], logf[:, t]
        m_new = torch.maximum(lft + m, lit)
        fw = torch.exp(lft + m - m_new)[..., None]          # [B,H,1]
        iw = torch.exp(lit - m_new)[..., None]
        C = fw[..., None] * C + (iw * kt)[..., :, None] * vt[..., None, :]
        n = fw * n + iw * kt
        num = torch.einsum("bhd,bhde->bhe", qt, C)
        den = torch.abs(torch.einsum("bhd,bhd->bh", qt, n))
        den = torch.maximum(den, torch.exp(-m_new))[..., None]
        hs.append(num / den)
        m = m_new
    return torch.stack(hs, dim=1).to(q.dtype), (C, n, m)


def mlstm_chunkwise(q, k, v, i_raw, f_raw, state=None, chunk: int = 256):
    """Chunked-parallel mLSTM; numerically matches mlstm_sequential."""
    B, T, H, dh = q.shape
    if state is None:
        state = init_mlstm_state(B, H, dh, device=q.device)
    if T % chunk:
        pad = (-T) % chunk

        def zpad(a):
            return F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
        h, st = mlstm_chunkwise(zpad(q), zpad(k), zpad(v),
                                F.pad(i_raw, (0, 0, 0, pad), value=-1e30),  # i=0
                                F.pad(f_raw, (0, 0, 0, pad), value=30.0),   # f=1
                                state, chunk)
        return h[:, :T], st
    L = chunk
    out_dtype = q.dtype
    q = mul_weak(q, dh ** -0.5).float()
    k, v = k.float(), v.float()
    logf = F.logsigmoid(f_raw.float())
    logi = i_raw.float()
    C, n, m0 = state                            # [B,H,dh,dh], [B,H,dh], [B,H]
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    hs = []
    for s0 in range(0, T, L):
        sl = slice(s0, s0 + L)
        qc, kc, vc, lic, lfc = q[:, sl], k[:, sl], v[:, sl], logi[:, sl], logf[:, sl]
        b = torch.cumsum(lfc, dim=1)                              # [B,L,H]
        a_hat = lic - b
        A_t = torch.cummax(a_hat, dim=1).values
        M_t = torch.maximum(m0[:, None], A_t)
        # intra-chunk: D[t,s] = exp(a_hat_s - M_t) for s<=t
        D = torch.exp(a_hat[:, None, :, :] - M_t[:, :, None, :])  # [B,t,s,H]
        D = torch.where(tri[None, :, :, None], D, 0.0)
        scores = torch.einsum("bthd,bshd->btsh", qc, kc) * D
        num = torch.einsum("btsh,bshd->bthd", scores, vc)
        den = scores.sum(dim=2)                                   # [B,t,H]
        # inter-chunk contribution from carry
        w0 = torch.exp(m0[:, None] - M_t)                         # [B,L,H]
        num = num + w0[..., None] * torch.einsum("bthd,bhde->bthe", qc, C)
        den = den + w0 * torch.einsum("bthd,bhd->bth", qc, n)
        m_t = b + M_t
        denom = torch.maximum(torch.abs(den), torch.exp(-m_t))[..., None]
        hs.append(num / denom)
        # carry update (in end-of-chunk units)
        bL = b[:, -1]                                             # [B,H]
        M_L = M_t[:, -1]
        wC = torch.exp(m0 - M_L)
        wk = torch.exp(a_hat - M_L[:, None])                      # [B,L,H]
        C = wC[..., None, None] * C + torch.einsum(
            "blhd,blhe->bhde", kc * wk[..., None], vc)
        n = wC[..., None] * n + (kc * wk[..., None]).sum(dim=1)
        m0 = bL + M_L
    h = torch.cat(hs, dim=1)
    return h.to(out_dtype), (C, n, m0)


def mlstm_step(q, k, v, i_raw, f_raw, state):
    """Single decode step. q,k,v: [B,1,H,dh]."""
    return mlstm_sequential(q, k, v, i_raw, f_raw, state)


def init_mlstm_state(B, H, dh, device=None):
    return (torch.zeros((B, H, dh, dh), dtype=torch.float32, device=device),
            torch.zeros((B, H, dh), dtype=torch.float32, device=device),
            torch.full((B, H), -1e30, dtype=torch.float32, device=device))


# ---------------------------------------------------------------------------
# causal depthwise conv1d (used by mLSTM and RG-LRU)
# ---------------------------------------------------------------------------
def causal_conv1d(x, w, buf: Optional[torch.Tensor] = None):
    """x: [B,T,D]; w: [W,D] depthwise. buf: [B,W-1,D] carried context.

    Returns (y [B,T,D], new_buf [B,W-1,D]).
    """
    W = w.shape[0]
    ctx = buf if buf is not None else torch.zeros(
        (x.shape[0], W - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xc = torch.cat([ctx.to(x.dtype), x], dim=1)                # [B,T+W-1,D]
    wd = w.to(x.dtype)
    T = x.shape[1]
    y = xc[:, 0:T, :] * wd[0][None, None, :]
    for i in range(1, W):
        y = y + xc[:, i:i + T, :] * wd[i][None, None, :]
    return y, xc[:, -(W - 1):, :]


# ---------------------------------------------------------------------------
# mLSTM block (pre-norm residual, own up/down projections; proj_factor 2)
# ---------------------------------------------------------------------------
def _heads(x, w, dt):
    """einsum("bti,ihd->bthd", x, w) in ``dt``."""
    B, T, _ = x.shape
    return (x @ w.to(dt).reshape(w.shape[0], -1)).reshape(B, T, *w.shape[1:])


def apply_mlstm_block(params, x, cfg, state=None, mode="train"):
    """x: [B,T,d] -> (y, new_state). state=(cell_state, conv_buf)."""
    dt = x.dtype
    B, T, d = x.shape
    inner = int(cfg.mlstm_proj_factor * d)
    H = cfg.num_heads
    xn = rms_norm(x, params["ln"], cfg.norm_eps)
    up = xn @ params["w_up"].to(dt)
    z = xn @ params["w_z"].to(dt)
    cell_state, conv_buf = state if state is not None else (None, None)
    c, conv_buf = causal_conv1d(up, params["conv_w"], conv_buf)
    c = silu(c)
    q = _heads(c, params["w_q"], dt)
    k = _heads(c, params["w_k"], dt)
    v = _heads(up, params["w_v"], dt)
    i_raw = up @ params["w_i"].to(dt)
    f_raw = up @ params["w_f"].to(dt) + params["b_f"].to(dt)[None, None]
    if mode == "decode":
        h, cell_state = mlstm_step(q, k, v, i_raw, f_raw, cell_state)
    else:
        h, cell_state = mlstm_chunkwise(q, k, v, i_raw, f_raw, cell_state,
                                        chunk=min(256, max(T, 1)))
    h = h.reshape(B, T, inner)
    h = group_norm(h, params["gn"], H, cfg.norm_eps)
    out = (h.to(dt) * silu(z)) @ params["w_down"].to(dt)
    return x + out, (cell_state, conv_buf)


def init_mlstm_cache(cfg, batch, dtype, device=None):
    inner = int(cfg.mlstm_proj_factor * cfg.d_model)
    H = cfg.num_heads
    dh = inner // H
    return (init_mlstm_state(batch, H, dh, device=device),
            torch.zeros((batch, cfg.conv1d_width - 1, inner), dtype=dtype,
                        device=device))


# ---------------------------------------------------------------------------
# sLSTM block (sequential; scalar memory with recurrent gate connections)
# ---------------------------------------------------------------------------
def apply_slstm_block(params, x, cfg, state=None, mode="train"):
    """x: [B,T,d]. state = (c, n, h, m): c,n,h [B,d]; m [B,H]."""
    dt = x.dtype
    B, T, d = x.shape
    H = cfg.num_heads
    dh = d // H
    xn = rms_norm(x, params["ln"], cfg.norm_eps)
    gx = xn @ params["w_gates"].to(dt) + params["b_gates"].to(dt)  # [B,T,4d]
    if state is None:
        state = init_slstm_state(B, d, H, device=x.device)
    c, n, h, m = state
    r = params["r_gates"].float()
    hs = []
    for t in range(T):
        hh = h.reshape(B, H, dh)
        gr = torch.einsum("bhd,hde->bhe", hh, r).reshape(B, 4 * d)
        g = gx[:, t].float() + gr
        zi, ii, fi, oi = torch.split(g, d, dim=-1)
        z = torch.tanh(zi)
        o = sigmoid(oi)
        logi = ii.reshape(B, H, dh).mean(-1)     # per-head scalar gates
        logf = F.logsigmoid(fi).reshape(B, H, dh).mean(-1)
        m_new = torch.maximum(logf + m, logi)
        iw = torch.exp(logi - m_new)[..., None].expand(B, H, dh).reshape(B, d)
        fw = torch.exp(logf + m - m_new)[..., None].expand(B, H, dh).reshape(B, d)
        c = fw * c + iw * z
        n = fw * n + iw
        h = o * c / torch.clamp_min(n, 1e-6)
        m = m_new
        hs.append(h)
    hseq = torch.stack(hs, dim=1).to(dt)                          # [B,T,d]
    hseq = group_norm(hseq, params["gn"], H, cfg.norm_eps)
    u, g = torch.chunk(hseq @ params["w_up"].to(dt), 2, dim=-1)
    out = (u * silu(g)) @ params["w_down"].to(dt)
    return x + out, (c, n, h, m)


def init_slstm_state(B, d, H, device=None):
    z = lambda: torch.zeros((B, d), dtype=torch.float32, device=device)  # noqa: E731
    return (z(), z(), z(),
            torch.full((B, H), -1e30, dtype=torch.float32, device=device))


def init_slstm_cache(cfg, batch, dtype, device=None):
    return init_slstm_state(batch, cfg.d_model, cfg.num_heads, device=device)


# ---------------------------------------------------------------------------
# norms (shared)
# ---------------------------------------------------------------------------
def rms_norm(x, scale, eps):
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


def group_norm(x, scale, groups, eps):
    """Per-head group norm over the channel dim. x: [B,T,D]."""
    B, T, D = x.shape
    xg = x.reshape(B, T, groups, D // groups).float()
    mu = xg.mean(-1, keepdim=True)
    var = xg.var(-1, unbiased=False, keepdim=True)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    return xg.reshape(B, T, D).to(x.dtype) * scale.to(x.dtype)
