"""The collectives of the distributed step, behind one interface.

:class:`StackedCollective` runs R ranks in one process (one card, or the
CPU): a per-rank value is a tensor stacked ``[R, ...]`` on its leading
axis, as shard_map lays out the reference's ranks.

  * ``all_to_all(x)``: rank s's send buffer ``x[s]`` is ``[R_dst, ...]``;
    rank d receives ``[R_src, ...]`` — a swap of the two rank axes.
  * ``psum(x)``: every rank gets the sum over ranks, taken in rank order.

A ``torch.distributed`` backend (one process per rank, NCCL on the
cards) takes the same calls in a later slice.
"""
from __future__ import annotations

import torch


class StackedCollective:
    """R ranks in one process, per-rank values stacked ``[R, ...]``."""

    def __init__(self, num_ranks: int):
        self.num_ranks = num_ranks

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
        return x.transpose(0, 1).contiguous()

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """``[R, ...]`` -> ``[...]``, summed in rank order."""
        self._check(x)
        out = x[0]
        for r in range(1, self.num_ranks):
            out = out + x[r]
        return out
