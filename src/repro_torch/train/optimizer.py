"""Adam with a global-norm clip, and plain SGD (own copy of
``repro/train/optimizer.py``'s ``AdamConfig``/``adam_init``/
``global_norm``/``adam_update``/``sgd_update``).

The reference's pure functions return new pytrees; here the parameters
and the moments are updated in place, under ``no_grad``, in the same
arithmetic: float32 moments, bias correction by ``b ** step``, the clip
scale ``min(1, clip / (norm + 1e-9))``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 0.0        # 0 = off


@dataclasses.dataclass
class AdamState:
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    step: int = 0


def adam_init(params: Sequence[torch.Tensor]) -> AdamState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return AdamState(mu=[zeros(p) for p in params],
                     nu=[zeros(p) for p in params])


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares, leaves summed in order."""
    total = torch.zeros((), dtype=torch.float32, device=tensors[0].device)
    for x in tensors:
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


@torch.no_grad()
def adam_update(grads: Sequence[torch.Tensor], state: AdamState,
                params: Sequence[torch.Tensor], cfg: AdamConfig) -> dict:
    """One Adam step in place on ``params`` and ``state``; returns the
    diagnostics ``{"grad_norm": tensor}`` (the norm before the clip)."""
    state.step += 1
    dev = params[0].device
    gnorm = global_norm(grads)
    if cfg.grad_clip > 0:
        clip = torch.full((), cfg.grad_clip, device=dev)
        scale = torch.clamp_max(clip / (gnorm + 1e-9), 1.0)
        grads = [g * scale for g in grads]
    step = torch.full((), state.step, dtype=torch.float32, device=dev)
    c1 = 1 - torch.pow(torch.full((), cfg.b1, device=dev), step)
    c2 = 1 - torch.pow(torch.full((), cfg.b2, device=dev), step)
    for g, mu, nu, p in zip(grads, state.mu, state.nu, params):
        g = g.float()
        mu.copy_(cfg.b1 * mu + (1 - cfg.b1) * g)
        nu.copy_(cfg.b2 * nu + (1 - cfg.b2) * torch.square(g))
        delta = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - cfg.lr * delta)
    return {"grad_norm": gnorm}


def sgd_update(grads: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
               lr: float) -> Sequence[torch.Tensor]:
    """Plain SGD, ``p - lr * g`` in float32, in place; returns ``params``."""
    with torch.no_grad():
        for p, g in zip(params, grads):
            p.copy_((p.float() - lr * g.float()).to(p.dtype))
    return params
