"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427; port
of ``repro/models/transformer/rglru.py``).

Real-Gated Linear Recurrent Unit:
    r_t = sigmoid(x_t W_a + b_a)          (recurrence gate)
    i_t = sigmoid(x_t W_x + b_x)          (input gate)
    log a_t = -c * softplus(Lambda) * r_t (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The recurrence is diagonal-linear -> parallel over time with an inclusive
scan on (a, b) pairs (log2 T doubling steps, as the reference's
``associative_scan`` is parallel; both reorder the float sums, so the two
agree within rounding, not bit for bit); decode is a single fused step.
Block layout (one Griffin temporal-mixing block):
    ln -> [gelu(x W1)] * [RG-LRU(conv1d(x W2))] -> W_out, residual.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.transformer.xlstm import (causal_conv1d, rms_norm,
                                                  sigmoid)

_C = 8.0


def _decay(r, lam):
    log_a = -_C * F.softplus(lam.float()) * r.float()
    return torch.exp(log_a), torch.sqrt(torch.clamp_min(
        1.0 - torch.exp(2.0 * log_a), 1e-12))


def rglru_scan(x, r, i, lam, h0=None):
    """x, r, i: [B,T,W]; lam: [W]. Returns (h [B,T,W], h_last [B,W])."""
    a, norm = _decay(r, lam)
    b = norm * (i * x).float()
    if h0 is not None:
        # absorb carried state into the first step: h_1 = a_1 h0 + b_1
        b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]],
                      dim=1)
    # inclusive scan of (a1, b1) o (a2, b2) = (a1 a2, a2 b1 + b2)
    T, off = a.shape[1], 1
    while off < T:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b.to(x.dtype), b[:, -1, :]


def rglru_step(x, r, i, lam, h_prev):
    """Single decode step: x, r, i: [B,1,W]; h_prev [B,W]."""
    a, norm = _decay(r[:, 0], lam)
    h = a * h_prev.float() + norm * (i[:, 0] * x[:, 0]).float()
    return h[:, None, :].to(x.dtype), h


def apply_rglru_block(params, x, cfg, state=None, mode="train"):
    """x: [B,T,d] -> (y, state). state = (h [B,W], conv_buf [B,cw-1,W])."""
    dt = x.dtype
    xn = rms_norm(x, params["ln"], cfg.norm_eps)
    y1 = F.gelu(xn @ params["w1"].to(dt), approximate="tanh")
    y2 = xn @ params["w2"].to(dt)
    h_prev, conv_buf = state if state is not None else (None, None)
    y2, conv_buf = causal_conv1d(y2, params["conv_w"], conv_buf)
    r = sigmoid(y2 @ params["w_a"].to(dt) + params["b_a"].to(dt))
    i = sigmoid(y2 @ params["w_x"].to(dt) + params["b_x"].to(dt))
    if mode == "decode":
        if h_prev is None:
            h_prev = torch.zeros((x.shape[0], cfg.rnn_width),
                                 dtype=torch.float32, device=x.device)
        h, h_last = rglru_step(y2, r, i, params["lam"], h_prev)
    else:
        h, h_last = rglru_scan(y2, r, i, params["lam"], h_prev)
    out = (h * y1) @ params["w_out"].to(dt)
    return x + out, (h_last, conv_buf)


def init_rglru_cache(cfg, batch, dtype, device=None):
    return (torch.zeros((batch, cfg.rnn_width), dtype=torch.float32,
                        device=device),
            torch.zeros((batch, cfg.conv1d_width - 1, cfg.rnn_width),
                        dtype=dtype, device=device))
