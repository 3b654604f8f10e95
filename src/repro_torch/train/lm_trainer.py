"""LM training and serving steps for the assigned architectures (port of
``repro/train/lm_trainer.py``: ``make_train_step``, ``make_prefill_step``
and ``make_serve_step``; the abstract specs of the dry run are not
ported yet)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.transformer import model as M
from repro_torch.train import loss as loss_lib
from repro_torch.train import optimizer as opt_lib


def _extra(batch) -> Optional[dict]:
    extra = {k: v for k, v in batch.items()
             if k in ("patch_embeds", "frame_embeds", "positions")}
    return extra or None


def make_train_step(cfg, opt_cfg: opt_lib.AdamConfig):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the forward in train mode (remat per unit under
    ``cfg.remat``), the VLM's text suffix only, :func:`chunked_lm_loss`,
    ``loss.backward()``, and Adam over the leaves in the reference's order
    (``M.tree_leaves``).  ``params`` (a tree of tensors, or its
    ``TransformerLM``) and ``opt_state`` (``adam_init(M.tree_leaves(
    params))``) are updated in place and returned; ``metrics`` holds the
    ``loss`` and the ``grad_norm`` before the clip, as 0-d tensors."""
    def loss_fn(params, batch):
        hidden = M.forward(params, cfg, batch["tokens"], _extra(batch),
                           mode="train")
        if cfg.num_patch_tokens:          # VLM: loss only on the text suffix
            hidden = hidden[:, cfg.num_patch_tokens:]
        return loss_lib.chunked_lm_loss(params, cfg, hidden, batch["labels"])

    def train_step(params, opt_state, batch):
        tree = M.as_params(params)
        leaves = M.tree_leaves(tree)
        for p in leaves:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss = loss_fn(tree, batch)
                loss.backward()
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in leaves]
        finally:
            for p in leaves:
                p.grad = None
                p.requires_grad_(False)
        diag = opt_lib.adam_update(grads, opt_state, leaves, opt_cfg)
        return params, opt_state, {"loss": loss.detach(), **diag}

    return train_step


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
