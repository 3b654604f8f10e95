"""Batched serving scheduler (continuous-batching-lite; port of
``repro/serve/scheduler.py``).

Serves any of the assigned architectures with a FIXED device batch of
decode slots:

  * requests queue up with a prompt; free slots are claimed per step,
  * each step decodes ONE token for every slot (one batched decode),
  * prompts are injected via teacher-forced decode steps on the slot's
    cache region (per-slot positions; the position-driven attention mask
    keeps slots independent),
  * finished requests (eos or max_tokens) free their slot immediately.

The reference runs the step as a ``vmap`` of single-sequence decode over
the slots.  Here it is one decode with a position per row
(``decode_step(..., pos=[num_slots])``): each row writes its KV at its own
slot (``pos % S`` on a ring, ``min(pos, S - 1)`` otherwise), rotates by
its own position, masks by its own position, and an MoE FFN routes each
row as a group of its own, as under the vmap.  Slot reuse needs no cache
zeroing beyond resetting the slot's rows (positions -1, zero states).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer import model as M


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list
    max_tokens: int
    eos_id: Optional[int] = None
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False


class BatchScheduler:
    def __init__(self, cfg, params, num_slots: int, cache_len: int,
                 extra: Optional[dict] = None, device=None):
        self.cfg = cfg
        self.params = M.as_params(params)
        self.device = resolve_device(device)
        self.num_slots = num_slots
        self.cache_len = cache_len
        self.caches = M.init_cache(cfg, num_slots, cache_len,
                                   device=self.device)
        self.slot_req: list[Optional[Request]] = [None] * num_slots
        self.slot_pos = np.zeros(num_slots, np.int64)
        self.slot_tok = np.zeros((num_slots, 1), np.int32)
        self.slot_prompt_left: list[deque] = [deque() for _ in range(num_slots)]
        self.queue: deque[Request] = deque()
        self.steps_run = 0

    @torch.no_grad()
    def _step(self, tokens: torch.Tensor, positions: torch.Tensor):
        logits, self.caches = M.decode_step(self.params, self.cfg,
                                            self.caches, tokens, positions)
        return torch.argmax(logits[:, -1, :], dim=-1)

    # -- public API --------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for s in range(self.num_slots):
            if self.slot_req[s] is None and self.queue:
                req = self.queue.popleft()
                self.slot_req[s] = req
                self.slot_pos[s] = 0
                self.slot_prompt_left[s] = deque(req.prompt)
                self.slot_tok[s, 0] = self.slot_prompt_left[s].popleft()
                self._reset_slot_cache(s)

    def _reset_slot_cache(self, s: int):
        """Write a freshly-initialized slot (positions -1, zero states) —
        slot reuse never sees a previous request's cache/recurrent state."""
        fresh = M.init_cache(self.cfg, 1, self.cache_len, device=self.device)
        M.tree_map(lambda a, f: a[:, s].copy_(f[:, 0]), self.caches, fresh)

    def step(self):
        """One decode step across all slots (inactive ones too, as the
        reference's vmap does: admission resets what they write)."""
        self._admit()
        active = [s for s in range(self.num_slots) if self.slot_req[s]]
        if not active:
            return False
        tokens = torch.as_tensor(self.slot_tok, device=self.device)
        positions = torch.as_tensor(self.slot_pos, device=self.device)
        nxt = self._step(tokens, positions).cpu().numpy()
        self.steps_run += 1
        for s in active:
            req = self.slot_req[s]
            self.slot_pos[s] += 1
            if self.slot_prompt_left[s]:
                # still teacher-forcing the prompt
                self.slot_tok[s, 0] = self.slot_prompt_left[s].popleft()
                continue
            tok = int(nxt[s])
            req.generated.append(tok)
            self.slot_tok[s, 0] = tok
            if (req.eos_id is not None and tok == req.eos_id) or \
                    len(req.generated) >= req.max_tokens or \
                    self.slot_pos[s] >= self.cache_len - 1:
                req.done = True
                self.slot_req[s] = None
        return True

    def run(self, max_steps: int = 10_000) -> int:
        """Drive until queue + slots drain. Returns decode steps executed."""
        while (self.queue or any(self.slot_req)) and max_steps > 0:
            if not self.step():
                break
            max_steps -= 1
        return self.steps_run


def serve_requests(cfg, params, requests, num_slots=4, cache_len=64,
                   device=None):
    """Convenience entry point: schedule `requests`, run to completion."""
    sched = BatchScheduler(cfg, params, num_slots, cache_len, device=device)
    for r in requests:
        sched.submit(r)
    while sched.queue or any(sched.slot_req):
        if not sched.step():
            break
    return requests, sched.steps_run
