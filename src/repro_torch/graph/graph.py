"""CSR graph container (host-side numpy; sampling happens on host like DGL).

Edges are stored un-directed (both directions present), matching the paper's
Table 1 note ("directed edges ... converted to un-directed").
Own numpy copy of ``repro/graph/graph.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Graph:
    indptr: np.ndarray       # [V+1] int64
    indices: np.ndarray      # [E]   int32/int64 neighbor ids
    features: np.ndarray     # [V, F] float32
    labels: np.ndarray       # [V]   int32
    train_mask: np.ndarray   # [V]   bool
    test_mask: np.ndarray    # [V]   bool

    @property
    def num_vertices(self) -> int:
        return len(self.indptr) - 1

    @property
    def num_edges(self) -> int:
        return len(self.indices)

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]

    def validate(self):
        assert self.indptr[0] == 0 and self.indptr[-1] == len(self.indices)
        assert np.all(np.diff(self.indptr) >= 0)
        assert self.indices.min(initial=0) >= 0
        assert self.indices.max(initial=-1) < self.num_vertices
        assert len(self.features) == self.num_vertices
        assert len(self.labels) == self.num_vertices
        return self


def from_edges(src: np.ndarray, dst: np.ndarray, num_vertices: int,
               features: np.ndarray, labels: np.ndarray,
               train_mask: np.ndarray, test_mask: np.ndarray,
               symmetrize: bool = True) -> Graph:
    if symmetrize:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    # dedupe + sort by (src, dst)
    key = src.astype(np.int64) * num_vertices + dst.astype(np.int64)
    key = np.unique(key)
    src = (key // num_vertices).astype(np.int64)
    dst = (key % num_vertices).astype(np.int64)
    indptr = np.zeros(num_vertices + 1, np.int64)
    np.add.at(indptr, src + 1, 1)
    indptr = np.cumsum(indptr)
    return Graph(indptr=indptr, indices=dst.astype(np.int32),
                 features=features.astype(np.float32),
                 labels=labels.astype(np.int32),
                 train_mask=train_mask.astype(bool),
                 test_mask=test_mask.astype(bool)).validate()
