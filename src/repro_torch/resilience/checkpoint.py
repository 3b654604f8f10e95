"""Epoch-boundary checkpoints of the full distributed training state (own
copy of ``repro/resilience/checkpoint.py``).

One checkpoint is one atomic archive (``train/checkpoint.py``, the
reference's format) of the whole ``DistTrainer`` state: the parameters,
Adam, every layer's HEC, the hot tier and the delay-d in-flight push
queue, with the epoch it was written after.  The sampler needs no state
of its own: every minibatch is a pure function of ``(base_seed, epoch,
step)``, so restoring the checkpoint written after epoch ``k`` and going
on with ``start_epoch=k+1`` gives the uninterrupted run's bits.

Layout under ``ckpt_dir``::

    ckpt_ep00003.npz   the state archive
    LATEST             text: "ckpt_ep00003.npz 3"

Both are written to a temporary file and moved into place, so a crash
mid-save leaves the previous checkpoint whole and pointed to.
"""
from __future__ import annotations

import os
import re
from typing import Optional, Tuple

from repro_torch.train import checkpoint as ckpt_lib

_CKPT_RE = re.compile(r"^ckpt_ep(\d+)\.npz$")


class CheckpointManager:
    def __init__(self, ckpt_dir: str, every: int = 1, keep: int = 3):
        if every < 1:
            raise ValueError("ckpt every must be >= 1")
        self.ckpt_dir = ckpt_dir
        self.every = every
        self.keep = keep
        os.makedirs(ckpt_dir, exist_ok=True)

    def path_for(self, epoch: int) -> str:
        return os.path.join(self.ckpt_dir, f"ckpt_ep{epoch:05d}.npz")

    def should_save(self, epoch: int) -> bool:
        return (epoch + 1) % self.every == 0

    def save(self, state: dict, epoch: int) -> str:
        path = ckpt_lib.save(self.path_for(epoch), state, step=epoch)
        latest = os.path.join(self.ckpt_dir, "LATEST")
        tmp = latest + ".tmp"
        with open(tmp, "w") as f:
            f.write(f"{os.path.basename(path)} {epoch}\n")
        os.replace(tmp, latest)
        self._prune()
        return path

    def latest(self) -> Optional[Tuple[str, int]]:
        """``(path, epoch)`` of the newest checkpoint, or ``None``."""
        latest = os.path.join(self.ckpt_dir, "LATEST")
        if os.path.exists(latest):
            with open(latest) as f:
                name, epoch = f.read().split()
            path = os.path.join(self.ckpt_dir, name)
            if os.path.exists(path):
                return path, int(epoch)
        # LATEST lost or stale: scan the directory
        best = None
        for name in os.listdir(self.ckpt_dir):
            m = _CKPT_RE.match(name)
            if m:
                ep = int(m.group(1))
                if best is None or ep > best[1]:
                    best = (os.path.join(self.ckpt_dir, name), ep)
        return best

    def restore(self, state: dict) -> Tuple[dict, int]:
        """Restore the newest checkpoint into ``state``, in place.

        Returns ``(state, epoch)``, ``epoch`` the one the checkpoint was
        written after: go on with ``start_epoch = epoch + 1``.  Raises
        ``FileNotFoundError`` when the directory holds no checkpoint and
        ``CheckpointMismatchError`` when the state's structure differs."""
        got = self.latest()
        if got is None:
            raise FileNotFoundError(
                f"no checkpoint found under {self.ckpt_dir}")
        return ckpt_lib.restore(got[0], state)

    def _prune(self) -> None:
        if self.keep < 1:
            return
        found = []
        for name in os.listdir(self.ckpt_dir):
            m = _CKPT_RE.match(name)
            if m:
                found.append((int(m.group(1)), name))
        for _, name in sorted(found)[:-self.keep]:
            try:
                os.remove(os.path.join(self.ckpt_dir, name))
            except OSError:
                pass
