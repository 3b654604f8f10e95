"""Synthetic graphs with a learnable node-classification task.

No OGBN data is available offline, so we generate power-law graphs with
community structure (stochastic block model flavored with preferential
attachment): labels = community id, features = noisy community prototype +
per-node noise.  GraphSAGE/GAT reach high accuracy on these, which lets the
convergence-parity experiments (paper Table 3 / §4.5) run end-to-end.
Own numpy copy of ``repro/graph/synthetic.py``: the same seed gives the
same CSR, features and labels.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.graph import Graph, from_edges


def synthetic_graph(num_vertices: int = 20_000,
                    avg_degree: int = 10,
                    num_classes: int = 8,
                    feat_dim: int = 32,
                    train_frac: float = 0.1,
                    intra_prob: float = 0.8,
                    noise: float = 1.0,
                    seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    V = num_vertices
    comm = rng.integers(0, num_classes, V)

    # degree ~ lognormal (power-law-ish), preferential within community
    deg = np.clip(rng.lognormal(np.log(avg_degree), 0.6, V).astype(np.int64),
                  1, max(2 * avg_degree * 4, 16))
    E = int(deg.sum())
    src = np.repeat(np.arange(V, dtype=np.int64), deg)
    # destination: with prob intra_prob pick same community, else uniform
    same = rng.random(E) < intra_prob
    # community member lookup
    order = np.argsort(comm, kind="stable")
    comm_sorted = comm[order]
    starts = np.searchsorted(comm_sorted, np.arange(num_classes))
    ends = np.searchsorted(comm_sorted, np.arange(num_classes), side="right")
    dst = rng.integers(0, V, E)
    sc = comm[src]
    lo, hi = starts[sc], ends[sc]
    intra_pick = order[(lo + (rng.random(E) * (hi - lo)).astype(np.int64))
                       .clip(0, V - 1)]
    dst = np.where(same, intra_pick, dst)
    keep = src != dst
    src, dst = src[keep], dst[keep]

    proto = rng.normal(0, 1, (num_classes, feat_dim)).astype(np.float32)
    feats = proto[comm] + rng.normal(0, noise, (V, feat_dim)).astype(np.float32)

    train_mask = np.zeros(V, bool)
    test_mask = np.zeros(V, bool)
    perm = rng.permutation(V)
    n_train = int(train_frac * V)
    n_test = min(V - n_train, max(n_train, 1000))
    train_mask[perm[:n_train]] = True
    test_mask[perm[n_train:n_train + n_test]] = True

    return from_edges(src, dst, V, feats, comm.astype(np.int32),
                      train_mask, test_mask)
