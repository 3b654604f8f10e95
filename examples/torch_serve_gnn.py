"""Serve GNN inference queries with the HEC-backed serving cache on the
PyTorch/CUDA port (counterpart of ``examples/serve_gnn.py``).

Run:
  PYTHONPATH=src python examples/torch_serve_gnn.py [--device cpu]

Trains GraphSAGE briefly on a synthetic graph, then stands up the GNN
serving scheduler and demonstrates the three serving modes:
  1. cold queries (on-demand sampling + compute, cache filling),
  2. repeat queries (answered from the output cache, no compute),
  3. checkpoint update (model-version bump invalidates every cached
     embedding — no stale answers).
"""
import argparse

import numpy as np

from repro_torch.configs.gnn import small_gnn_config
from repro_torch.graph import partition_graph, synthetic_graph
from repro_torch.serve.gnn import (GNNServeConfig, GNNServeScheduler,
                                   ServeCacheConfig, layerwise_embeddings,
                                   warm_cache)
from repro_torch.train.gnn_trainer import DistTrainer, build_dist_data

VERTICES = 4000
EPOCHS = 3


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    g = synthetic_graph(num_vertices=VERTICES, avg_degree=8, num_classes=8,
                        feat_dim=32, seed=0)
    ps = partition_graph(g, 1, seed=0)
    part = ps.parts[0]

    # 1. train a model to serve (single rank, a few epochs)
    cfg = small_gnn_config("graphsage", batch_size=128, feat_dim=32,
                           num_classes=8)
    dd = build_dist_data(ps, cfg, args.device)
    trainer = DistTrainer(cfg=cfg, num_ranks=1, device=args.device)
    state = trainer.init_state(seed=0)
    state, hist = trainer.train_epochs(ps, dd, state, num_epochs=EPOCHS)
    model = state["model"]
    print(f"trained: loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")

    # 2. serving scheduler: fixed-slot microbatches + per-layer HEC cache
    srv = GNNServeScheduler(
        cfg, model, part,
        GNNServeConfig(num_slots=32,
                       cache=ServeCacheConfig(cache_size=16_384, ways=8)),
        device=args.device)
    rng = np.random.default_rng(1)
    vids = rng.integers(0, part.num_solid, 64)
    out = srv.serve(vids)
    print(f"cold serve: {len(vids)} queries -> classes "
          f"{np.argmax(out[:8], -1).tolist()}... "
          f"({srv.steps_run} microbatches)")

    # repeats hit the output cache: no sampling, no compute
    out2 = srv.serve(vids)
    m = srv.metrics()
    print(f"repeat serve: {m['fast_path_hits']} of {len(vids)} answered "
          f"from the output cache, microbatches still {srv.steps_run}; "
          f"identical results: {np.allclose(out, out2)}")

    # 3. pre-warm from the layer-wise offline engine (exact embeddings)
    srv.update_params(model)           # also how a new checkpoint installs
    warm_cache(srv.cache, layerwise_embeddings(cfg, srv.model, part),
               np.arange(part.num_solid))
    out3 = srv.serve(vids)
    agree = float(np.mean(np.argmax(out, -1) == np.argmax(out3, -1)))
    print(f"pre-warmed serve: exact offline embeddings (no sampling error), "
          f"class agreement with sampled inference: {agree:.2f}")

    # checkpoint update: model version bump drops every cached line
    v = srv.update_params(model)
    print(f"cache invalidated on checkpoint update (model_version={v}, "
          f"occupancy_l1={srv.metrics()['occupancy_l1']:.2f})")


if __name__ == "__main__":
    main()
