#!/usr/bin/env python3
"""Where the card's bfloat16 LM path parts from the CPU's: one
minitron-4b layer at its published widths (``chip_smoke.p14_unit``,
weights from ``chip_smoke.p14_params``), each op of the first block on
the same bf16 inputs on the card and on the CPU, with cuBLAS's bf16
reduced-precision reduction on and then off.

    PYTHONPATH=src python3 tools/lm_bf16_ops.py

Prints, per op, the share of its outputs that are equal bit for bit and
the largest difference: rms_norm, the q projection, the FFN's two input
products (and at M = 2, a decode step's shape), silu, the FFN's output
product, RoPE, the attention (float32 scores), and the float32 logits of
a bf16 hidden state.  Needs a CUDA card; TF32 is off.
"""
from __future__ import annotations

import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models.transformer import attention as TA  # noqa: E402
from repro_torch.models.transformer import blocks as TB  # noqa: E402
from repro_torch.models.transformer import model as M  # noqa: E402
from repro_torch.models.transformer import rope as TR  # noqa: E402
from repro_torch.models.transformer.xlstm import rms_norm, silu  # noqa: E402


def share(name, got, want):
    g, w = got.float().cpu(), want.float().cpu()
    print(f"  {name:10s} equal {float((g == w).float().mean()):.5f} "
          f"max|d| {float((g - w).abs().max()):.3e}")


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(cs.p14_unit(get_arch("minitron-4b")),
                              dtype="bfloat16")
    params = cs.p14_params(torch, M, cfg, 150, torch.float32)
    bp = {k: v[0] for k, v in params["seg0"]["b0"].items()}
    cbp = {k: v.cpu() for k, v in bp.items()}
    B, T, dt = 2, 32, torch.bfloat16
    x = torch.randn(B, T, cfg.d_model,
                    generator=torch.Generator().manual_seed(0)).to(dt)
    pos = torch.arange(T)[None].expand(B, T).int()
    for flag in (True, False):
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            flag
        print(f"bf16 reduced-precision reduction {flag}")
        xn = rms_norm(x, cbp["ln1"], cfg.norm_eps)
        share("rms_norm", rms_norm(x.cuda(), bp["ln1"], cfg.norm_eps), xn)
        q = TB._proj(xn, cbp["wq"], dt)
        share("q proj", TB._proj(xn.cuda(), bp["wq"], dt), q)
        h = xn @ cbp["w_in"].to(dt)
        share("w_in", xn.cuda() @ bp["w_in"].to(dt), h)
        share("w_in M=2", x[:, :1].cuda() @ bp["w_in"].to(dt),
              x[:, :1] @ cbp["w_in"].to(dt))
        share("silu", silu(h.cuda()), silu(h))
        share("w_out", h.cuda() @ bp["w_out"].to(dt), h @ cbp["w_out"].to(dt))
        ang = TR.rope_angles(pos.long(), cfg.head_dim, cfg.rope_theta, None)
        cos, sin = TR.rope_cos_sin(ang, dt)
        cos_g, sin_g = TR.rope_cos_sin(ang.cuda(), dt)
        share("rope", TR.rotate(q.cuda(), cos_g, sin_g), TR.rotate(q, cos, sin))
        k = TB._proj(xn, cbp["wk"], dt)
        v = TB._proj(xn, cbp["wv"], dt)
        share("attention", TA.dot_attention(q.cuda(), k.cuda(), v.cuda(),
                                            pos.cuda(), pos.cuda()),
              TA.dot_attention(q, k, v, pos, pos))
        top = {n: params[n] for n in ("embed", "unembed")}
        share("logits", M.logits_from_hidden(top, cfg, x[:, -1:].cuda()),
              M.logits_from_hidden(M.tree_map(lambda a: a.cpu(), top), cfg,
                                   x[:, -1:]))


if __name__ == "__main__":
    main()
