#!/usr/bin/env python3
"""The AEP push's two schedules, timed in turns on one card.

    PYTHONPATH=src python3 tools/push_schedule_compare.py [--steps 6] \
        [--rounds 4] [--model graphsage|gat]

On ``chip_smoke.py`` phase 4's graph and settings (``TRAIN_ARGS``,
400,000 vertices, 4 ranks, batch 1,000, HEC 1M x 8, nc 2,000; with
``--model gat`` phase 6's, lr 0.001), samples
the first ``--steps`` minibatches once, stages them on the card, and
then runs them through ``DistTrainer`` with ``overlap=True`` (each
rank's selection on the push stream before its backward) and
``overlap=False`` (the push inline after Adam), each run from a fresh
state, in turns (True, False, False, True, ...) for ``--rounds`` rounds.
No prefetch worker runs beside the steps, so the host clock sees the
step alone.  Per schedule it prints every run's median step (host wall,
the step ends in a host read of its metrics; step 0 left out), then one
traced run of each: the device busy time per step (the union over
streams), the push stream's device time per step and the share of it
that overlaps main-stream kernels.  The card's name and power limit
come first.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402


def run(torch, cfg, data, mbs, overlap, trace=False):
    """One run of ``mbs`` from a fresh state: the times (ms) of the steps
    after the first and, with ``trace``, their ``DeviceTrace``."""
    from repro_torch import obs
    from repro_torch.train.gnn_trainer import DistTrainer
    tr = DistTrainer(cfg, 4, device="cuda", overlap=overlap)
    st = tr.init_state(seed=0)
    tr.train_step(st, data, mbs[0], 0)
    secs = []
    with (obs.DeviceTrace("cuda") if trace
          else contextlib.nullcontext()) as dt:
        for j in range(1, len(mbs)):
            t0 = time.perf_counter()
            tr.train_step(st, data, mbs[j], j)
            secs.append(1e3 * (time.perf_counter() - t0))
    del st, tr
    torch.cuda.empty_cache()
    return secs, dt


BWD = cs.BWD_KERNELS + ("gat_bwd_kernel",)      # D, F and GAT's H


def traced_shares(obs, dt, steps):
    """Busy ms per step (union), and the push stream's ms per step and
    overlapped share (the push stream: any stream but the one of the
    gradient kernels that runs kernels)."""
    ev = [e for e in dt.events if e["cat"] != "device_memset"]
    main = {e["stream"] for e in ev if any(k in e["name"] for k in BWD)}
    busy = dt.summary()["busy_us"] / steps / 1e3
    if len(main) != 1:
        raise RuntimeError(f"gradient kernels on streams {sorted(main)}")
    main = main.pop()
    push = {e["stream"] for e in ev
            if e["stream"] != main and e["cat"] == "device_kernel"}
    kern = [e for e in ev if e["cat"] == "device_kernel"]
    own = sum(obs.busy_us([e for e in kern if e["stream"] == s])
              for s in push)
    over = sum(obs.stream_overlap_us(kern, s, [main]) for s in push)
    return busy, own / steps / 1e3, over / own if own else 0.0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--model", default="graphsage",
                    choices=["graphsage", "gat"])
    args = ap.parse_args(argv)
    import torch
    from repro_torch import obs
    from repro_torch.graph import partition_graph, synthetic_graph
    from repro_torch.kernels import _build
    from repro_torch.pipeline.prefetcher import SamplingPlan
    from repro_torch.pipeline.staging import device_stage
    from repro_torch.train.gnn_trainer import build_dist_data
    if not torch.cuda.is_available():
        raise SystemExit("push_schedule_compare: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    _build.build(cs.KERNELS)
    cfg = cs.launcher_config(cs.TRAIN_ARGS + (
        ["--model", "gat", "--lr", "0.001"] if args.model == "gat" else []))
    g = synthetic_graph(num_vertices=cs.TRAIN_VERTICES, avg_degree=10,
                        num_classes=cfg.num_classes, feat_dim=cfg.feat_dim,
                        seed=0)
    ps = partition_graph(g, 4, seed=0)
    plan = SamplingPlan(ps, cfg, 0, pin_memory=True)
    sched = plan.epoch_schedule(0)
    hosts = [plan.sample_host(0, i, sched[i]) for i in range(args.steps)]
    mbs = list(device_stage(iter(hosts), False, device="cuda"))
    data = build_dist_data(ps, cfg, "cuda")
    run(torch, cfg, data, mbs[:2], True)           # warm-up: loads, caches
    times = {True: [], False: []}
    for k in range(args.rounds):
        for ov in ((True, False) if k % 2 == 0 else (False, True)):
            secs, _ = run(torch, cfg, data, mbs, ov)
            times[ov].append(statistics.median(secs))
    for ov in (True, False):
        print(f"{args.model} overlap={ov}: median step ms per run "
              f"{[round(t, 1) for t in times[ov]]}, median "
              f"{statistics.median(times[ov]):.1f} [{card}]", flush=True)
    for ov in (True, False):
        secs, dt = run(torch, cfg, data, mbs, ov, trace=True)
        busy, push, share = traced_shares(obs, dt, args.steps - 1)
        print(f"{args.model} overlap={ov}, traced: step "
              f"{statistics.median(secs):.1f} ms, device busy {busy:.2f} "
              f"ms per step, push stream {push:.3f} ms per step, "
              f"{100 * share:.1f}% of it beside main-stream kernels "
              f"[{card}]")


if __name__ == "__main__":
    main()
