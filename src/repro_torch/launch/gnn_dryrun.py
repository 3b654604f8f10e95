"""Paper-scale GNN dry run (counterpart of ``repro/launch/gnn_dryrun.py``):
one DistGNN-MB training step at 64 ranks, the paper's largest
configuration, with its per-rank cost, collective schedule and roofline.

  python -m repro_torch.launch.gnn_dryrun [--ranks 64] [--model graphsage]
      [--device cuda|cpu]

The reference lowers and compiles its shard_map step and reads the cost
from the HLO.  Torch runs eagerly: here the R ranks are stacked on one
device (the trainer's collective), the first step is run and counted
(``utils/step_cost.py``: each kernel launch by its work formula, the
products outside the kernels by their shapes, every ``all_to_all`` and
``psum`` with its bytes per rank), and a second step is timed.  The
flags, the graph and the config are the reference's: batch 256,
fanouts (5, 10), hidden 256, HEC 65,536 x 8, nc 1024, delay 1.

Prints what the reference prints, with the build and first step in
place of lower+compile, the device's memory (on the card) in place of
``memory_analysis``, the roofline on the card's peaks
(``launch/mesh.py``) with the collective in two terms (on one card the
stacked all_to_all is a copy in HBM; across cards NVLink carries it,
the multi-card model), the AEP assertion (exactly one fused all_to_all
of ``aep_bytes_per_step`` bytes a rank), the overlap and the epoch
breakdown through ``obs.StepModel.from_roofline``, the health window and
the trace spans.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=64)
    ap.add_argument("--model", default="graphsage",
                    choices=["graphsage", "gat"])
    ap.add_argument("--vertices", type=int, default=30_000)
    ap.add_argument("--mode", default="aep", choices=["aep", "sync", "drop"])
    ap.add_argument("--hot-size", type=int, default=0,
                    help="replicated hot-vertex tier slots (0 disables); "
                         "refreshes ride the fused AEP push")
    ap.add_argument("--hot-budget", type=int, default=256,
                    help="hot rows broadcast per rank per step")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome trace-event JSON of the dry run's "
                         "phase spans (load in chrome://tracing / Perfetto)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the obs registry as JSONL")
    ap.add_argument("--flight-dir", default=".", metavar="DIR",
                    help="where the health plane dumps FLIGHT_*.json on a "
                         "detection or an escaped exception")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu (the kernels' plain "
                         "versions)")
    return ap.parse_args(argv)


def run(argv: Optional[Sequence[str]] = None, keep: bool = False) -> dict:
    """The dry run; prints its report and returns it: ``cost`` (the
    counted step, ``utils.step_cost``), ``push_model_bytes``, ``terms``
    (the roofline's seconds), ``param_bytes``, ``first_step_s``,
    ``step_s``, ``device_step_ms``, ``peak_bytes`` (None off the card)
    and ``logs`` (the two steps' metrics).  ``keep`` adds what a check
    of the run reads: ``mu`` (Adam's first moment after the counted
    step, on the host), ``ps``, ``cfg``, ``data``, ``state`` and
    ``trainer``."""
    args = parse_args(argv)
    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.configs.gnn import HECConfig, small_gnn_config
    from repro_torch.core.aep import aep_bytes_per_step, sync_bytes_per_step
    from repro_torch.device import resolve_device
    from repro_torch.graph import partition_graph, synthetic_graph
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh
    from repro_torch.pipeline.staging import (MinibatchPipeline,
                                              minibatch_to_device)
    from repro_torch.train.gnn_trainer import (DistTrainer, build_dist_data,
                                               layer_dims)
    from repro_torch.utils.step_cost import StepCost

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    obs.configure(obs.ObsConfig(
        trace=args.trace_out is not None, trace_path=args.trace_out,
        metrics_path=args.metrics_out))

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    R = args.ranks
    g = synthetic_graph(num_vertices=args.vertices, avg_degree=10,
                        num_classes=16, feat_dim=128, seed=0)
    t0 = time.time()
    ps = partition_graph(g, R, seed=0)
    print(f"partitioned V={g.num_vertices} into {R} ranks in "
          f"{time.time()-t0:.1f}s; edge-cut={ps.edge_cut_frac:.3f}; "
          f"train/rank={[int(p.train_mask.sum()) for p in ps.parts[:4]]}...")

    cfg = small_gnn_config(
        args.model, batch_size=256, feat_dim=128, num_classes=16,
        fanouts=(5, 10), hidden_size=256,
        hec=HECConfig(cache_size=65_536, ways=8, life_span=2,
                      push_limit=1024, delay=1, hot_size=args.hot_size,
                      hot_budget=args.hot_budget if args.hot_size else 0))
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    dd = build_dist_data(ps, cfg, dev)
    tr = DistTrainer(cfg=cfg, num_ranks=R, mode=args.mode, device=dev)
    state = tr.init_state(seed=0, dist_data=dd)
    if state["hot"]:
        K = dd["hot_vids"].shape[1]
        print(f"hot tier: {K} hub vertices replicated per rank; refresh "
              f"budget {args.hot_budget}/rank/step rides the fused push "
              f"(hot vids left the pairwise push contract)")

    # one minibatch from the pipeline's sampling plan (vectorized sampler),
    # sampled inline so that no prefetch worker outlives the measurement
    pipe = MinibatchPipeline(ps, cfg, base_seed=0, device=dev)
    sched = pipe.plan.epoch_schedule(0)
    t0 = time.time()
    mb = minibatch_to_device(pipe.plan.sample_host(0, 0, sched[0]), dev)
    sync()
    print(f"pipeline minibatch (vectorized sampler): one {R}-rank batch "
          f"sampled+staged in {time.time()-t0:.2f}s; training runs it with "
          f"{cfg.pipeline.num_workers} prefetch workers, depth "
          f"{cfg.pipeline.prefetch_depth}")

    # the build (on the card) and the first step, run and counted
    t0 = time.perf_counter()
    if cuda:
        _build.build(("hec_search", "update_fused", "sage_agg", "gat_edge"))
    t_build = time.perf_counter() - t0
    with StepCost(R, tr.comm) as cost:
        logs = [tr.train_step(state, dd, mb, seed=0)]
        tr.join_push()
        sync()
    t_first = time.perf_counter() - t0
    mu = [m.cpu().clone() for m in state["opt"].mu] if keep else None
    print(f"build + first step at {R} ranks: {t_first:.1f}s (kernel build "
          f"{t_build:.1f}s; the step counted)")
    peak = None
    if cuda:
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"device memory: {torch.cuda.memory_allocated(dev)/2**30:.2f}"
              f"GiB held, peak {peak/2**30:.2f}GiB of "
              f"{torch.cuda.get_device_properties(dev).total_memory/2**30:.2f}"
              f"GiB ({torch.cuda.get_device_name(dev)}), all {R} ranks")
    else:
        print("device memory: not measured (no CUDA device)")
    r = cost.analyze()
    print(f"per-device per-step: flops={r['flops']:.3e} "
          f"bytes={r['bytes_accessed']:.3e} "
          f"collective_bytes={r['collective_bytes']:.3e}")
    print("collective schedule:")
    for k, v in sorted(r["collectives"].items()):
        print(f"  {k:20s} count={v['count']:.0f} bytes={v['bytes']:.3e}")
    print("kernels (per rank): " + ", ".join(
        f"{k} {v['launches']:.0f}x" for k, v in r["kernels"].items())
        + f"; products outside them {r['products']['count']:.0f} "
        f"({r['products']['flops']:.3e} flops)")
    a2a = r["collectives"].get("all-to-all", {"count": 0, "bytes": 0.0})
    terms = {"compute_s": r["compute_s"], "memory_s": r["memory_s"],
             # one card: the stacked all_to_all is a copy in HBM (read and
             # written); across cards NVLink carries it each way
             "collective_s": 2.0 * r["collective_bytes"] / mesh.HBM_BW}
    nvlink_s = r["collective_bytes"] / mesh.NVLINK_BW
    dom = max(terms, key=terms.get)
    print(f"roofline ({mesh.CARD}): compute={terms['compute_s']*1e3:.3f}ms "
          f"memory={terms['memory_s']*1e3:.3f}ms "
          f"collective={terms['collective_s']*1e3:.3f}ms (a copy in HBM "
          f"on one card; over NVLink across cards {nvlink_s*1e3:.3f}ms) -> "
          f"{dom} bound; least step {r['bound_s']*1e3:.3f}ms (every "
          f"launch's bound, summed)")
    dims = layer_dims(cfg)
    push_model = aep_bytes_per_step(R, cfg.num_layers, cfg.hec.push_limit,
                                    dims)
    push_bytes = a2a["bytes"] if args.mode == "aep" else 0.0
    # one StepModel drives both the overlap print and the epoch breakdown;
    # its peak is the step's own mix of CUDA-core and tensor-core work
    peak_flops = r["flops"] / r["compute_s"] if r["compute_s"] else \
        mesh.PEAK_FP32_FLOPS
    model = obs.StepModel.from_roofline(
        r["flops"], r["bytes_accessed"], push_bytes, peak_flops, mesh.HBM_BW,
        mesh.HBM_BW / 2.0)
    across = obs.StepModel.from_roofline(
        r["flops"], r["bytes_accessed"], push_bytes, peak_flops, mesh.HBM_BW,
        mesh.NVLINK_BW)
    if args.mode == "aep":
        if a2a["count"] != 1:
            raise AssertionError(
                f"AEP must be the engine's ONE fused all_to_all push, got "
                f"{a2a['count']:.0f}")
        if not state["hot"] and a2a["bytes"] != push_model:
            raise AssertionError(
                f"the push moved {a2a['bytes']:.0f} B a rank, the model "
                f"aep_bytes_per_step {push_model} B")
        print(f"AEP fused all_to_all: {a2a['count']:.0f} op(s) "
              f"({a2a['bytes']:.3e} B/device/step; aep_bytes_per_step "
              f"{push_model:.3e}) — the engine's push, dispatched between "
              f"forward and backward (overlap mode)")
        for label, m in (("one card, a copy in HBM", model),
                         ("across cards, NVLink", across)):
            print(f"overlap ({label}): {a2a['bytes']:.3e} B/step behind "
                  f"the backward pass; modeled push latency hidden "
                  f"{m.overlap_efficiency()*100:.0f}% (push "
                  f"{m.push_s*1e6:.3f}us vs modeled backward "
                  f"{m.bwd_s*1e6:.3f}us of {m.work_s*1e6:.3f}us step work)")
    elif args.mode == "sync":
        model_b = sync_bytes_per_step(R, cfg.hec.push_limit, cfg.feat_dim)
        print(f"sync fetch: {a2a['count']:.0f} all_to_all op(s) "
              f"({a2a['bytes']:.3e} B/device/step; sync_bytes_per_step "
              f"{model_b:.3e})")

    # the timed step: the same minibatch from the counted step's state
    health = obs.HealthPlane(
        obs.HealthConfig(flight_dir=args.flight_dir), num_ranks=R,
        expected_halo_rows=[p.num_halo for p in ps.parts])
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] \
        if cuda else None
    with health.guard("dryrun_step"), obs.span("step", step=0):
        sync()
        t0 = time.perf_counter()
        if ev:
            ev[0].record()
        logs.append(tr.train_step(state, dd, mb, seed=1))
        tr.join_push()
        if ev:
            ev[1].record()
        sync()
        t_step = time.perf_counter() - t0
    device_ms = ev[0].elapsed_time(ev[1]) if ev else None
    print(f"step: {t_step*1e3:.1f} ms wall, " + (
        f"{device_ms:.1f} ms on the device stream" if ev
        else "device time not measured (no CUDA device)")
        + f"; {R} ranks in one process")
    acc = health.new_accumulator()
    acc.add(tr.rank_stats)
    totals = acc.finish()
    totals["rank_step_seconds"] = np.full(R, t_step)
    obs.publish_rank_series(obs.get().registry, totals)
    health.observe_epoch(totals, wall_s=t_step)
    halo = totals["rank_halo_rows"]
    skew = obs.skew_ratio(halo)
    print(f"health: per-rank halo rows min={halo.min():.0f} "
          f"max={halo.max():.0f} "
          f"skew={'n/a' if skew is None else f'{skew:.2f}'}; "
          f"{len(health.detections)} detections")
    fwd_s, push_s, bwd_s = model.split_step(t_step)
    tracer = obs.get().tracer
    if tracer.enabled:
        scale = t_step / model.step_s if model.step_s > 0 else 0.0
        base = t0 - tracer.epoch
        tracer.add_complete("fwd", base, fwd_s, track="device (modeled)")
        tracer.add_complete("bwd", base + fwd_s, bwd_s + push_s,
                            track="device (modeled)")
        tracer.add_complete("aep_push", base + fwd_s,
                            model.push_s * scale, track="comm (modeled)")
    reg = obs.get().registry
    bd = obs.EpochBreakdown(model)
    bd.add_epoch(sample=reg.value("phase_seconds", phase="sample"),
                 host_prep=reg.value("phase_seconds", phase="host_prep"),
                 stage=reg.value("phase_seconds", phase="stage"),
                 step=t_step)
    print("epoch breakdown (1 step; device step split by the roofline "
          "model):")
    print(bd.table())
    for path in obs.flush():
        print(f"wrote {path}")
    params = sum(t.numel() * t.element_size()
                 for t in state["model"].parameter_list())
    rep = {"cost": r, "push_model_bytes": push_model, "terms": terms,
           "param_bytes": params,
           "nvlink_s": nvlink_s, "first_step_s": t_first,
           "step_s": t_step, "device_step_ms": device_ms,
           "peak_bytes": peak, "logs": logs}
    if keep:
        rep.update(mu=mu, ps=ps, cfg=cfg, data=dd, state=state, trainer=tr)
    return rep


def main(argv: Optional[Sequence[str]] = None):
    run(argv)


if __name__ == "__main__":
    main()
