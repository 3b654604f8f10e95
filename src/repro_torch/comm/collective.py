"""The collectives of the distributed step, behind one interface.

:class:`StackedCollective` runs R ranks in one process (one card, or the
CPU): a per-rank value is a tensor stacked ``[R, ...]`` on its leading
axis, as shard_map lays out the reference's ranks.

  * ``all_to_all(x)``: rank s's send buffer ``x[s]`` is ``[R_dst, ...]``;
    rank d receives ``[R_src, ...]`` — a swap of the two rank axes.
  * ``psum(x)``: every rank gets the sum over ranks, taken in rank order.

A ``torch.distributed`` backend (one process per rank, NCCL on the
cards) takes the same calls in a later slice.

:meth:`StackedCollective.record` lists every collective of a window with
its bytes per rank (the counterpart of reading them from the step's HLO,
``repro/utils/hlo.py``); off, it costs one attribute test per call.
"""
from __future__ import annotations

import contextlib
from typing import List, Tuple

import torch


class StackedCollective:
    """R ranks in one process, per-rank values stacked ``[R, ...]``."""

    def __init__(self, num_ranks: int):
        self.num_ranks = num_ranks
        self.log = None            # while recording: [(kind, bytes), ...]

    @contextlib.contextmanager
    def record(self):
        """Within the block, every ``all_to_all`` and ``psum`` appends
        ``("all-to-all" | "all-reduce", bytes one rank receives)`` to the
        list it yields (the reference's HLO names)."""
        log: List[Tuple[str, int]] = []
        self.log = log
        try:
            yield log
        finally:
            self.log = None

    def _note(self, kind: str, x: torch.Tensor):
        if self.log is not None:
            self.log.append((kind, x[0].numel() * x.element_size()))

    def _check(self, x: torch.Tensor):
        if x.shape[0] != self.num_ranks:
            raise ValueError(f"leading axis {x.shape[0]} is not the "
                             f"{self.num_ranks} ranks")

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``[R_src, R_dst, ...]`` -> ``[R_dst, R_src, ...]``."""
        self._check(x)
        if x.shape[1] != self.num_ranks:
            raise ValueError(f"send axis {x.shape[1]} is not the "
                             f"{self.num_ranks} ranks")
        self._note("all-to-all", x)
        return x.transpose(0, 1).contiguous()

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """``[R, ...]`` -> ``[...]``, summed in rank order."""
        self._check(x)
        self._note("all-reduce", x)
        out = x[0]
        for r in range(1, self.num_ranks):
            out = out + x[r]
        return out
