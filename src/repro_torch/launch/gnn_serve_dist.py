"""Sharded multi-rank GNN serving run, R ranks on one card (counterpart of
``repro/launch/gnn_serve_dist.py``):

  python -m repro_torch.launch.gnn_serve_dist [--ranks 4]
      [--model graphsage|gat]
      [--preset small|graphsage-papers100m|gat-papers100m]
      [--vertices 20000] [--slots 32] [--halo-slots 256] [--queries 1024]
      [--overlap 0.5] [--cache-size 65536] [--policy degree]
      [--prewarm-frac F] [--hot-size 2048] [--no-dedup] [--round-batch 4]
      [--device cuda] [--trace-out PATH] [--metrics-out PATH]
      [--prom-out PATH] [--flight-dir DIR] [--slo-p99-ms T]
      [--audit-interval N] [--quality-budget ERR]

Flow (the reference launcher's, with its defaults): synthetic power-law
graph -> min-cut partitions -> ``DistGNNServeScheduler`` (a warm-up pass
that builds the kernels, then the caches and counters are dropped) ->
per-shard caches pre-warmed by **distributed offline inference** under
the selected policy (default degree-weighted, a quarter of each shard's
solids; the hot tier's replicas take the whole hot set) -> the query
workload routed to owner shards and served with the per-layer halo
fetches -> the same workload again, with the overlapping neighborhoods
now resident.  Presets as in ``repro_torch.launch.gnn_serve``; weights
the reference launcher's, from ``jax.random.key(0)``.  ``--trace-out``
traces the run (on the card with the device's kernels and copies, and
prints the device busy share of the two passes as the union of device
intervals); ``--metrics-out`` and ``--prom-out`` write the registry.  As
in the reference, a health plane watches every round's per-rank series
(load skew, edge-cut drift against the partition's halo profile, SLO
burn with ``--slo-p99-ms``, hot-tier decay; flight dumps under
``--flight-dir``), and with ``--audit-interval`` a quality plane audits
every shard's cache and the hot replicas after each pass.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch

from repro_torch.launch.common import (add_obs_flags, add_plane_flags,
                                       build_planes, configure_obs,
                                       device_trace, finish_obs, print_audit,
                                       print_health, prom_writer,
                                       report_device)
from repro_torch.launch.gnn_serve import PRESETS, model_config, workload


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--vertices", type=int, default=20_000)
    ap.add_argument("--model", default=None, choices=["graphsage", "gat"],
                    help="graphsage (default) or gat; a papers100m preset "
                         "names its own")
    ap.add_argument("--preset", default="small", choices=PRESETS)
    ap.add_argument("--slots", type=int, default=32)
    ap.add_argument("--halo-slots", type=int, default=256)
    ap.add_argument("--queries", type=int, default=1024)
    ap.add_argument("--overlap", type=float, default=0.5,
                    help="fraction of queries that repeat earlier ones")
    ap.add_argument("--cache-size", type=int, default=65_536)
    ap.add_argument("--policy", default="degree",
                    choices=["degree", "query_log", "none"],
                    help="cache pre-warm policy (default degree-weighted)")
    ap.add_argument("--prewarm-frac", type=float, default=None,
                    help="override the policy's default fraction "
                         "(degree: 0.25, query_log: 1.0)")
    ap.add_argument("--hot-size", type=int, default=2048,
                    help="replicated hot-vertex tier slots (0 disables)")
    ap.add_argument("--no-dedup", action="store_true",
                    help="disable cross-query neighborhood dedup")
    ap.add_argument("--round-batch", type=int, default=4,
                    help="serve rounds fused into one step/collective")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch versions of "
                         "the kernels)")
    add_obs_flags(ap)
    add_plane_flags(ap, serving=True)
    return ap.parse_args(argv)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args: argparse.Namespace) -> dict:
    """The launcher's flow; prints its report and returns the server, the
    partitions, the workload, each pass's requests, metrics and q/s."""
    from repro_torch.device import resolve_device
    from repro_torch.graph import partition_graph, synthetic_graph
    from repro_torch.models.gnn import build_model
    from repro_torch.serve.gnn import ServeCacheConfig, prewarm
    from repro_torch.serve.gnn.distributed import (DistGNNServeScheduler,
                                                   DistServeConfig)

    device = resolve_device(args.device)
    configure_obs(args)
    prom = prom_writer(args)
    cfg = model_config(args.preset, args.model)
    R = args.ranks
    g = synthetic_graph(num_vertices=args.vertices, avg_degree=8,
                        num_classes=cfg.num_classes, feat_dim=cfg.feat_dim,
                        seed=0)
    ps = partition_graph(g, R, seed=0)
    heads = f", {cfg.num_heads} heads" if cfg.model == "gat" else ""
    print(f"serving graph: {g.num_vertices} vertices over {R} shards, edge "
          f"cut {ps.edge_cut_frac:.2%}, shard sizes "
          f"{[p.num_solid for p in ps.parts]}; model {cfg.name} "
          f"({cfg.feat_dim}->{cfg.hidden_width}x{cfg.num_layers - 1}"
          f"->{cfg.num_classes}{heads}, fanouts {tuple(cfg.fanouts)}) on "
          f"{device}")
    model = build_model(cfg, seed=0, device=device)
    # the partition's halo rows per rank (ExchangePlan.
    # expected_inbound_rows) arm the edge-cut drift detector
    health, quality = build_planes(
        args, R, expected_halo_rows=[p.num_halo for p in ps.parts],
        prom=prom)
    srv = DistGNNServeScheduler(
        cfg, model, ps,
        DistServeConfig(num_slots=args.slots, halo_slots=args.halo_slots,
                        cache=ServeCacheConfig(cache_size=args.cache_size,
                                               ways=8),
                        hot_size=args.hot_size, dedup=not args.no_dedup,
                        round_batch=args.round_batch),
        device=device, health=health, quality=quality)
    if srv.hot is not None:
        print(f"hot tier:   {srv.hot.num_slots} hub vertices replicated on "
              f"every shard; dedup={not args.no_dedup}, "
              f"round_batch={args.round_batch}")
    vids = workload(g.num_vertices, args.queries, args.overlap)

    # warm-up outside any reported timing (the first launches build and
    # load the kernels), then drop the caches AND the counters
    srv.serve(vids[:2 * args.slots * R])
    warmup_metrics = srv.metrics()
    srv.update_params(model)
    srv.cache.reset_counters()
    srv.reset_frontend()
    out = {"srv": srv, "cfg": cfg, "ps": ps, "vids": vids,
           "warmup_metrics": warmup_metrics, "prewarmed": 0,
           "health": health, "quality": quality, "audits": []}

    if args.policy != "none":
        t0 = time.perf_counter()
        n = prewarm(srv, policy=args.policy, frac=args.prewarm_frac,
                    query_log=vids if args.policy == "query_log" else None)
        _sync(device)
        out["prewarmed"] = n
        print(f"pre-warm:   policy={args.policy} stored {n} vertices/layer "
              f"across {R} shards in {time.perf_counter() - t0:.3f}s")

    with device_trace(args, device) as trace, \
            health.guard("serve_rounds"):
        for name in ("serve", "repeat"):
            if name == "repeat":
                srv.cache.reset_counters()
                if srv.hot is not None:
                    srv.hot.reset_counters()
                srv.reset_frontend()
            t0 = time.perf_counter()
            reqs = [srv.submit(v) for v in vids]
            srv.pump()
            _sync(device)
            dt = time.perf_counter() - t0
            m = srv.metrics()
            out[name] = reqs
            out[f"{name}_metrics"] = m
            out[f"{name}_qps"] = args.queries / dt
            print(f"{name + ':':11s} {args.queries} queries in {dt:.3f}s "
                  f"({args.queries / dt:.0f} q/s), {m['steps_run']} rounds, "
                  f"{m['fast_path_hits']} fast-path answers; latency "
                  f"p50={m['latency_p50_ms']:.1f}ms "
                  f"p99={m['latency_p99_ms']:.1f}ms")
            print(f"halo:       {m['halo_seen']} rows seen, "
                  f"{m['halo_local_hits']} served locally (cached-halo frac "
                  f"{m['cached_halo_frac']:.2f}), {m['halo_fetched']} fetched "
                  f"via all_to_all ({m['halo_requested']} rows requested)")
            if srv.hot is not None:
                print(f"heavy tail: {m['hot_hits']} hub rows from the local "
                      f"replica, {m['hot_fast_path_hits']} tier fast-path "
                      f"answers, {m['dedup_merged']} queries deduped into "
                      f"shared slots")
            if quality is not None:
                out["audits"].append(srv.audit())
                print_audit(name, out["audits"][-1])
    print(f"speedup:    {out['repeat_qps'] / out['serve_qps']:.1f}x the "
          f"first pass's q/s")
    out["device_trace"] = report_device(trace, "serve and repeat passes")
    print_health(health)
    finish_obs(prom)
    return out


def main(argv: Optional[Sequence[str]] = None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
