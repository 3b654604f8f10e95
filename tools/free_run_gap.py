#!/usr/bin/env python3
"""Where a free-running card run of the trainer parts from the CPU's.

    PYTHONPATH=src python3 tools/free_run_gap.py [--repeats 3] \
        [--models graphsage gat]

On ``chip_smoke.py`` phase 9 (c)'s graph, batch and HEC (``CHECK_*``,
full widths, 4 ranks), runs the first two steps of every mode (``sync``,
``drop``, ``aep`` without the tier and ``aep`` with phase 9's tier) once
on the CPU through the plain versions and ``--repeats`` times free on the
card, and prints per card run the loss and gradient-norm gaps to the
CPU's at each step and the three leaves whose Adam first moment sits
furthest from the CPU's after step 1 (relative in norm).

For GraphSAGE it also runs the card with the AGG forward's plain version
(``kernels/ref.py``) in place of kernel E at step 0, at step 1 or at
both, and prints kernel E's distance from its plain version on the
inputs the run gave it (the largest relative norm over the step's
calls), so a gap can be laid to E's rounding or cleared of it, and the
number of UPDATE outputs per step whose ReLU took the other branch than
on the CPU (an output is 0 in one run and not in the other; the hash
dropout zeroes the same outputs in both).  GAT's runs take the exact
ReLU branches of their own inputs (``chip_smoke.ExactReluBranches``),
the CPU's and the card's alike.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402

MODES = (("sync", False), ("drop", False), ("aep", False), ("aep", True))


class AggForward:
    """While active, step ``i`` of a run computes the AGG forward with
    kernel E when ``kernel[i]``, else with its plain version; with
    ``measure`` each kernel call is also held against the plain version
    (``gaps[i]``: the largest relative norm of the mean over the step)."""

    def __init__(self, torch, kernel, measure=False):
        from repro_torch.kernels import ref
        from repro_torch.kernels import sage_agg as sa
        self.torch, self.sa, self.ref = torch, sa, ref
        self.kernel, self.measure, self.step = kernel, measure, 0
        self.gaps = [0.0] * len(kernel)

    def __enter__(self):
        sa, ref, self.orig = self.sa, self.ref, self.sa.sage_agg_fwd

        def fwd(h, nbr, valid):
            if not self.kernel[self.step]:
                return ref.sage_agg_ref(h, nbr, valid)
            mean, cnt = self.orig(h, nbr, valid)
            if self.measure:
                want, _ = ref.sage_agg_ref(h, nbr, valid)
                self.gaps[self.step] = max(self.gaps[self.step],
                                           cs.rel_norm(mean, want))
            return mean, cnt
        fwd.launches = 0             # the wrapper counts on its own name
        sa.sage_agg_fwd = fwd
        return self

    def __exit__(self, *exc):
        self.sa.sage_agg_fwd = self.orig


class ReluZeros:
    """While active, records which outputs of every GraphSAGE UPDATE with
    a ReLU are 0, tagged with ``step``."""

    def __init__(self):
        from repro_torch.models.gnn import graphsage
        self.gs, self.step, self.zeros = graphsage, 0, []

    def __enter__(self):
        self.orig = self.gs.fused_update

        def update(*args, relu, **kw):
            out = self.orig(*args, relu=relu, **kw)
            if relu:
                self.zeros.append((self.step, (out == 0).cpu()))
            return out
        self.gs.fused_update = update
        return self

    def __exit__(self, *exc):
        self.gs.fused_update = self.orig


def run(torch, cfg, mode, device, ps, hosts, model, agg=None):
    """Two free steps; per step the metrics, Adam's first moment, and the
    UPDATE outputs' zeros."""
    from repro_torch.train.gnn_trainer import (DistTrainer, build_dist_data,
                                               minibatch_to_device)
    tr = DistTrainer(cfg, 4, mode=mode, device=device)
    data = build_dist_data(ps, cfg, device)
    st = tr.init_state(seed=0, dist_data=data)
    logs = []
    with ReluZeros() as rec:
        for i, host in enumerate(hosts):
            rec.step = i
            if agg is not None:
                agg.step = i
            pin = cs.ExactReluBranches(torch) if model == "gat" \
                else contextlib.nullcontext()
            with pin:
                logs.append(tr.train_step(
                    st, data, minibatch_to_device(host, device), i))
    return logs, [m.cpu().clone() for m in st["opt"].mu], rec.zeros


def report(label, got, want, model):
    (logs, mu, zeros), (ref_logs, ref_mu, ref_zeros) = got, want
    gaps = ["step {}: loss {:.2e} grad norm {:.2e}".format(
        i, abs(a["loss"] - b["loss"]) / abs(b["loss"]),
        abs(a["grad_norm"] - b["grad_norm"]) / abs(b["grad_norm"]))
        for i, (a, b) in enumerate(zip(logs, ref_logs))]
    names = cs.LEAF_NAMES[model]
    leaves = sorted(((cs.rel_norm(x, y), f"l{k // len(names)}."
                      f"{names[k % len(names)]}") for k, (x, y) in
                     enumerate(zip(mu, ref_mu))), reverse=True)
    flips = [0] * len(logs)
    for (i, a), (_, b) in zip(zeros, ref_zeros):
        flips[i] += int((a != b).sum())
    print(f"  {label}: " + "; ".join(gaps) + "; Adam mu furthest at "
          + ", ".join(f"{n} {v:.2e}" for v, n in leaves[:3])
          + ("; ReLU branches unlike the CPU's per step "
             + "/".join(map(str, flips)) if zeros else ""), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--models", nargs="+", default=["graphsage", "gat"])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("free_run_gap: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.graph import partition_graph, synthetic_graph
    from repro_torch.kernels import _build
    from repro_torch.pipeline.prefetcher import SamplingPlan
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"{torch.cuda.get_device_name(0)}; {smi.stdout.strip()}")
    _build.build(cs.KERNELS)
    g = synthetic_graph(num_vertices=cs.CHECK_VERTICES, avg_degree=10,
                        num_classes=172, feat_dim=128, seed=0)
    ps = partition_graph(g, 4, seed=0)
    base = {"graphsage": cs.TRAIN_ARGS,
            "gat": cs.TRAIN_ARGS + ["--model", "gat", "--lr", "0.001"]}
    for model in args.models:
        for mode, hot in MODES:
            if model == "gat" and mode == "aep" and not hot:
                continue
            t0 = time.perf_counter()
            extra = dict(hot_size=cs.HOT_SIZE, hot_budget=cs.HOT_BUDGET) \
                if hot else {}
            cfg = cs.launcher_config(base[model], batch_size=cs.CHECK_BATCH)
            cfg = dataclasses.replace(cfg, hec=dataclasses.replace(
                cfg.hec, cache_size=cs.CHECK_HEC_SIZE, **extra))
            plan = SamplingPlan(ps, cfg, 0)
            sched = plan.epoch_schedule(0)
            hosts = [plan.sample_host(0, i, sched[i])
                     for i in range(cs.CHECK_STEPS)]
            print(f"{model} {mode}{' with the tier' if hot else ''}: free "
                  f"card runs against the CPU's", flush=True)
            want = run(torch, cfg, mode, "cpu", ps, hosts, model)
            for k in range(args.repeats):
                if model == "graphsage":
                    with AggForward(torch, [True] * cs.CHECK_STEPS,
                                    measure=True) as agg:
                        got = run(torch, cfg, mode, "cuda", ps, hosts,
                                  model, agg)
                    label = (f"kernel E, run {k} (E vs plain " + ", ".join(
                        f"step {i} {v:.2e}" for i, v in enumerate(agg.gaps))
                        + ")")
                else:
                    got = run(torch, cfg, mode, "cuda", ps, hosts, model)
                    label = f"run {k}"
                report(label, got, want, model)
            if model == "graphsage":
                for pick in ((False, False), (False, True), (True, False)):
                    with AggForward(torch, list(pick)) as agg:
                        got = run(torch, cfg, mode, "cuda", ps, hosts,
                                  model, agg)
                    report("E at steps 0/1: " + "/".join(
                        "kernel" if p else "plain" for p in pick), got,
                        want, model)
            print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
