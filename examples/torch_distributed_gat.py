"""Distributed GAT training with mode comparison (aep vs sync vs drop) on
the PyTorch/CUDA port (counterpart of ``examples/distributed_gat.py``).

Reproduces the paper's central claim in miniature: the HEC+AEP mode reaches
the same accuracy as the blocking-fetch baseline while communicating
asynchronously (and beats the drop-halos mode on accuracy).

Minibatches flow through the port's pipeline: vectorized CSR sampling on
a prefetch thread and copies to the card one batch ahead.

  PYTHONPATH=src python examples/torch_distributed_gat.py [--device cpu]
"""
import argparse

from repro_torch.configs.gnn import PipelineConfig, small_gnn_config
from repro_torch.core import aep
from repro_torch.graph import partition_graph, synthetic_graph
from repro_torch.train.gnn_trainer import (DistTrainer, build_dist_data,
                                           layer_dims)

RANKS = 4
VERTICES = 8_000
EPOCHS = 6


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    g = synthetic_graph(num_vertices=VERTICES, avg_degree=10, num_classes=8,
                        feat_dim=32, seed=1)
    ps = partition_graph(g, RANKS, seed=0)
    pipe_cfg = PipelineConfig(num_workers=1, prefetch_depth=1)
    print(f"minibatch pipeline: {pipe_cfg.num_workers} prefetch workers, "
          f"depth {pipe_cfg.prefetch_depth}, double-buffered staging")
    for mode in ("aep", "sync", "drop"):
        cfg = small_gnn_config("gat", batch_size=128, feat_dim=32,
                               num_classes=8, lr=0.005, pipeline=pipe_cfg)
        dd = build_dist_data(ps, cfg, args.device)
        tr = DistTrainer(cfg=cfg, num_ranks=RANKS, mode=mode,
                         device=args.device)
        state = tr.init_state(seed=0)
        state, hist = tr.train_epochs(ps, dd, state, num_epochs=EPOCHS)
        acc = tr.evaluate(ps, dd, state)
        dims = layer_dims(cfg)
        comm = (aep.aep_bytes_per_step(RANKS, cfg.num_layers,
                                       cfg.hec.push_limit, dims)
                if mode == "aep" else
                aep.sync_bytes_per_step(RANKS, cfg.hec.push_limit,
                                        cfg.feat_dim)
                if mode == "sync" else 0)
        tag = " (async, overlapped)" if mode == "aep" else \
              " (blocking)" if mode == "sync" else ""
        print(f"{mode:5s}: test_acc={acc:.3f} comm_bytes/step={comm}{tag}")


if __name__ == "__main__":
    main()
