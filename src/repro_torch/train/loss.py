"""Losses (port of ``repro/train/loss.py``).  The LM loss is
*vocab-chunked*: the logits of the whole sequence are never
materialised.  The reference scans over token chunks and computes each
chunk's [B, chunk, V] logits and cross-entropy inside the step; here each
chunk runs under ``torch.utils.checkpoint``, so autograd keeps only the
chunk's inputs and recomputes its logits in the backward: the live
buffer is one chunk's logits in the forward and in the backward alike.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """logits [..., V] float32; labels [...] int. Returns the mean over
    ``mask``."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.to(nll.dtype)
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def _chunk_nll(logits_fn, params, cfg, hc, yc, mc):
    """The masked negative log-likelihood summed over one chunk."""
    logits = logits_fn(params, cfg, hc).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, yc[..., None].long())[..., 0]
    return ((logz - gold) * mc).sum()


def chunked_lm_loss(params, cfg, hidden, labels, mask=None,
                    num_chunks: int = 16, logits_fn=None):
    """hidden [B,T,d]; labels [B,T].  The token-count-normalised loss over
    at most ``num_chunks`` chunks of T (the largest divisor of T at or
    under it), chunk sums added in order, as the reference's scan."""
    from repro_torch.models.transformer.model import logits_from_hidden
    logits_fn = logits_fn or logits_from_hidden
    B, T, d = hidden.shape
    num_chunks = min(num_chunks, T)
    while T % num_chunks:
        num_chunks -= 1
    C = T // num_chunks
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=hidden.device)
    mask = mask.float()
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    grad = torch.is_grad_enabled()
    for c in range(num_chunks):
        sl = slice(c * C, (c + 1) * C)
        args = (logits_fn, params, cfg, hidden[:, sl], labels[:, sl],
                mask[:, sl])
        nll = (checkpoint(_chunk_nll, *args, use_reentrant=False) if grad
               else _chunk_nll(*args))
        tot = tot + nll
        cnt = cnt + mask[:, sl].sum()
    return tot / torch.clamp_min(cnt, 1.0)
