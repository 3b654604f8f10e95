#!/usr/bin/env python3
"""What the ``stage`` span costs with and without a busy Python thread.

    PYTHONPATH=src python3 tools/stage_gil_probe.py [--batches 6]

On ``chip_smoke.py`` phase 4's graph and settings, samples ``--batches``
pinned minibatches, then stages them with ``device_stage`` on the card,
double-buffered and in order (twice each, in turns), first alone and
then beside a thread that spins in Python (as a prefetch worker's
sampling loop holds the GIL), and prints the ``stage`` span's ms per
batch and the loop's ms per batch (each yield followed by a device
synchronise), with the batch's bytes and the interpreter's switch
interval.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=6)
    args = ap.parse_args(argv)
    import torch
    from repro_torch import obs
    from repro_torch.graph import partition_graph, synthetic_graph
    from repro_torch.pipeline.prefetcher import SamplingPlan
    from repro_torch.pipeline.staging import device_stage
    if not torch.cuda.is_available():
        raise SystemExit("stage_gil_probe: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = cs.launcher_config(cs.TRAIN_ARGS)
    g = synthetic_graph(num_vertices=cs.TRAIN_VERTICES, avg_degree=10,
                        num_classes=cfg.num_classes, feat_dim=cfg.feat_dim,
                        seed=0)
    plan = SamplingPlan(partition_graph(g, 4, seed=0), cfg, 0,
                        pin_memory=True)
    sched = plan.epoch_schedule(0)
    hosts = [plan.sample_host(0, i, sched[i]) for i in range(args.batches)]
    nbytes = sum(a.numel() * a.element_size() for v in hosts[0].values()
                 for a in (v if isinstance(v, list) else [v]))
    print(f"card: {card}; {nbytes} bytes a batch; switch interval "
          f"{sys.getswitchinterval()} s")
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            pass
    for busy in (False, True):
        th = threading.Thread(target=spin) if busy else None
        if th:
            th.start()
        for db in (True, False, True, False):
            obs.configure()
            t0 = time.perf_counter()
            for _ in device_stage(iter(hosts), db, device="cuda"):
                torch.cuda.synchronize()
            loop = (time.perf_counter() - t0) / len(hosts)
            print(f"busy thread {busy}, double_buffer {db}: stage "
                  f"{1e3 * obs.phase_seconds('stage') / len(hosts):.3f} ms "
                  f"a batch, loop {1e3 * loop:.3f} ms [{card}]")
        if th:
            stop.set()
            th.join()
    obs.configure()


if __name__ == "__main__":
    main()
