"""LM serving steps for the assigned architectures (port of the serving
half of ``repro/train/lm_trainer.py``: ``make_prefill_step`` and
``make_serve_step``; the train step and the abstract specs wait for the
training slice)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.transformer import model as M


def _extra(batch) -> Optional[dict]:
    extra = {k: v for k, v in batch.items()
             if k in ("patch_embeds", "frame_embeds", "positions")}
    return extra or None


def make_prefill_step(cfg):
    @torch.no_grad()
    def prefill_step(params, batch):
        hidden, caches = M.forward(params, cfg, batch["tokens"],
                                   _extra(batch), mode="prefill")
        last = hidden[:, -1:, :]
        logits = M.logits_from_hidden(params, cfg, last)
        return logits, caches
    return prefill_step


def make_serve_step(cfg):
    """One decode step: new token against a seq_len-deep cache (updated in
    place)."""
    @torch.no_grad()
    def serve_step(params, caches, token, pos, extra=None):
        logits, caches = M.decode_step(params, cfg, caches, token, pos, extra)
        next_token = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
        return next_token.to(torch.int32), logits, caches
    return serve_step
