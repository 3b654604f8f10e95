"""GNN inference serving run on the card (counterpart of
``repro/launch/gnn_serve.py``):

  python -m repro_torch.launch.gnn_serve [--model graphsage|gat]
      [--preset small|graphsage-papers100m|gat-papers100m]
      [--vertices 20000] [--slots 32] [--queries 1024] [--overlap 0.5]
      [--cache-size 65536] [--no-prewarm] [--device cuda]
      [--trace-out PATH] [--metrics-out PATH] [--prom-out PATH]

Flow: synthetic power-law graph -> single-partition serving graph ->
``GNNServeScheduler`` (fixed-slot microbatches, HEC-backed cache) serves a
query workload cold; the layer-wise offline engine then computes exact
full-graph embeddings, pre-warms the cache, and the same workload is
served again — the second pass answers from the output cache without
sampling or compute.

Presets: ``small`` is the reference launcher's CPU-sized model of
``--model`` (feat 32, hidden 64, 2 layers, 16 classes, fanouts 5,10; GAT
with 4 heads); ``graphsage-papers100m`` and ``gat-papers100m`` are the
paper's full widths (feat 128, hidden 256, 3 layers, 172 classes,
fanouts 5,10,15; GAT with 4 heads of 256 and one of 172 at the last
layer), and fix the model.  The weights are the reference launcher's:
``init_model_params(jax.random.key(0), cfg)``, drawn without jax
(``models/gnn/init.py``).  ``--trace-out`` traces the timed passes (on
the card with the device's kernels and copies, and prints the device
busy share of the cold pass as the union of device intervals);
``--metrics-out`` and ``--prom-out`` write the registry.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.launch.common import (add_obs_flags, configure_obs,
                                       device_trace, finish_obs, prom_writer,
                                       report_device)

PRESETS = ("small", "graphsage-papers100m", "gat-papers100m")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default=None, choices=["graphsage", "gat"],
                    help="graphsage (default) or gat; a papers100m preset "
                         "names its own")
    ap.add_argument("--preset", default="small", choices=PRESETS)
    ap.add_argument("--vertices", type=int, default=20_000)
    ap.add_argument("--slots", type=int, default=32)
    ap.add_argument("--queries", type=int, default=1024)
    ap.add_argument("--overlap", type=float, default=0.5,
                    help="fraction of queries that repeat earlier ones")
    ap.add_argument("--cache-size", type=int, default=65_536)
    ap.add_argument("--no-prewarm", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch versions of "
                         "the kernels)")
    add_obs_flags(ap)
    return ap.parse_args(argv)


def model_config(preset: str, model: Optional[str] = None):
    """The preset's config; ``model`` picks the small preset's model and
    must agree with a papers100m preset's."""
    from repro_torch.configs.gnn import (GAT_PAPERS100M, GRAPHSAGE_PAPERS100M,
                                         small_gnn_config)
    paper = {"graphsage-papers100m": GRAPHSAGE_PAPERS100M,
             "gat-papers100m": GAT_PAPERS100M}
    if preset in paper:
        cfg = paper[preset]
        if model is not None and model != cfg.model:
            raise SystemExit(f"--model {model} does not match --preset "
                             f"{preset}")
        return cfg
    return small_gnn_config(model or "graphsage", batch_size=64, feat_dim=32,
                            num_classes=16, fanouts=(5, 10), hidden_size=64)


def workload(num_vertices: int, queries: int, overlap: float) -> np.ndarray:
    """The reference launcher's query stream: a pool of unique vids plus
    repeats drawn from it, shuffled (numpy seed 0)."""
    rng = np.random.default_rng(0)
    n_unique = max(1, int(round(queries * (1 - overlap))))
    pool = rng.choice(num_vertices, size=n_unique, replace=False)
    vids = np.concatenate(
        [pool, rng.choice(pool, size=queries - n_unique, replace=True)])
    rng.shuffle(vids)
    return vids


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args: argparse.Namespace) -> dict:
    """The launcher's flow; prints its report and returns the server, the
    workload, both passes' requests, the offline embeddings and rates."""
    from repro_torch.device import resolve_device
    from repro_torch.graph import partition_graph, synthetic_graph
    from repro_torch.models.gnn import build_model
    from repro_torch.serve.gnn import (GNNServeConfig, GNNServeScheduler,
                                       ServeCacheConfig, layerwise_embeddings,
                                       warm_cache)

    device = resolve_device(args.device)
    cfg = model_config(args.preset, args.model)
    g = synthetic_graph(num_vertices=args.vertices, avg_degree=8,
                        num_classes=cfg.num_classes, feat_dim=cfg.feat_dim,
                        seed=0)
    part = partition_graph(g, 1, seed=0).parts[0]
    heads = f", {cfg.num_heads} heads" if cfg.model == "gat" else ""
    print(f"serving graph: {part.num_solid} vertices, "
          f"{len(part.indices)} edges; model {cfg.name} "
          f"({cfg.feat_dim}->{cfg.hidden_width}x{cfg.num_layers - 1}"
          f"->{cfg.num_classes}{heads}, fanouts {tuple(cfg.fanouts)}) on "
          f"{device}")
    model = build_model(cfg, seed=0, device=device)
    srv = GNNServeScheduler(
        cfg, model, part,
        GNNServeConfig(num_slots=args.slots,
                       cache=ServeCacheConfig(cache_size=args.cache_size,
                                              ways=8)),
        device=device)
    vids = workload(part.num_solid, args.queries, args.overlap)

    # warm-up outside any reported timing (first launches build and load
    # the kernels), then reset cache AND counters
    srv.serve(vids[:2 * args.slots])
    srv.update_params(model)
    srv.cache.reset_counters()
    srv.reset_frontend()

    reg = configure_obs(args).registry
    prom = prom_writer(args)
    with device_trace(args, device) as trace:
        t0 = time.perf_counter()
        cold = [srv.submit(v) for v in vids]
        srv.pump()
        _sync(device)
        t_cold = time.perf_counter() - t0
    m = srv.metrics()
    steps = max(m["steps_run"], 1)
    breakdown = {ph: reg.value("phase_seconds", phase=ph) * 1e3 / steps
                 for ph in ("serve_round", "serve_sample", "serve_step",
                            "serve_sync_host")}
    out = {"srv": srv, "cfg": cfg, "part": part, "vids": vids,
           "cold": cold, "cold_qps": args.queries / t_cold,
           "cold_metrics": m, "cold_ms_per_microbatch": breakdown}
    print(f"cold:       {args.queries} queries in {t_cold:.3f}s "
          f"({args.queries / t_cold:.0f} q/s), {m['steps_run']} "
          f"microbatches; hit rates "
          + " ".join(f"l{k}={m[f'hit_rate_l{k}']:.2f}"
                     for k in range(1, cfg.num_layers + 1))
          + f"; occupancy l1={m['occupancy_l1']:.2f}; latency "
          f"p50={m['latency_p50_ms']:.2f}ms p99={m['latency_p99_ms']:.2f}ms")
    print("cold round: " + ", ".join(
        f"{ph.removeprefix('serve_')} {ms:.2f}" for ph, ms in
        breakdown.items()) + " ms per microbatch (host clock)")
    out["device_trace"] = report_device(trace, "cold pass")

    if not args.no_prewarm:
        srv.update_params(model)
        t0 = time.perf_counter()
        embs = layerwise_embeddings(cfg, srv.model, part)
        n = warm_cache(srv.cache, embs, np.unique(vids))
        _sync(device)
        t_warm_build = time.perf_counter() - t0
        print(f"pre-warm:   offline layer-wise inference + store of {n} "
              f"vertices in {t_warm_build:.3f}s")
        fp0 = srv.metrics()["fast_path_hits"]
        srv.reset_frontend()
        t0 = time.perf_counter()
        warm = [srv.submit(v) for v in vids]
        srv.pump()
        _sync(device)
        t_warm = time.perf_counter() - t0
        m = srv.metrics()
        out.update(embs=embs, warm=warm, warm_qps=args.queries / t_warm,
                   warm_metrics=m)
        print(f"pre-warmed: {args.queries} queries in {t_warm:.3f}s "
              f"({args.queries / t_warm:.0f} q/s), "
              f"{m['fast_path_hits'] - fp0} fast-path answers, "
              f"{m['steps_run']} microbatches -> "
              f"{t_cold / t_warm:.1f}x cold throughput")
    finish_obs(prom)
    return out


def main(argv: Optional[Sequence[str]] = None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
