"""Training launcher (counterpart of ``repro/launch/train.py gnn``).

  python -m repro_torch.launch.train gnn [--model graphsage|gat] \\
      --ranks 4 --vertices 20000 --epochs 5 [--device cuda]

Distributed minibatch GraphSAGE or GAT in ``--mode aep`` (the paper's
HEC and delayed push, the default), ``sync`` (fresh layer-0 halos
fetched every step) or ``drop`` (halos dropped): a synthetic power-law
graph, partitioned into ``--ranks`` parts, trained by ``--ranks`` ranks
that run in one process on one device (the stacked collective backend).
The flags and defaults are the reference launcher's, for what the port
has; ``--device`` (default ``cuda``) picks the card or, with ``cpu``, the
plain PyTorch versions of the kernels.  ``--trace-out``,
``--metrics-out`` and ``--prom-out`` write the phase spans (on the card
with the device's kernels and copies, one track per CUDA stream, and the
device busy share printed), the registry as JSONL and in Prometheus
text.  As in the reference, a health plane (rank series, skew and
edge-cut drift against the partition's halo profile, flight dumps under
``--flight-dir``) and a quality plane (HEC staleness every epoch, the
exactness audit every ``--audit-interval`` epochs, ``--quality-budget``)
ride along; they only read.  The resilience flags are not offered yet.
As in the reference, the initial weights come from
``jax.random.key(--seed)`` (drawn without jax) and the AEP push draws
the reference's uniforms, so both launchers train the same model on the
same pushes.  As there, the hot tier, the pipeline's settings and the
push's schedule have no flag (``HECConfig.hot_size``/``hot_budget``,
``PipelineConfig``, ``DistTrainer.overlap``; ``run_gnn`` takes the last
two).

Prints the graph, the partition, per-epoch loss, accuracy and HEC hit
rates, and ``done: ... s/epoch; test_acc=...``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.launch.common import (add_obs_flags, add_plane_flags,
                                       build_planes, configure_obs,
                                       device_trace, finish_obs, print_health,
                                       prom_writer, report_device)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("gnn")
    g.add_argument("--model", default="graphsage",
                   choices=["graphsage", "gat"])
    g.add_argument("--mode", default="aep", choices=["aep", "sync", "drop"])
    g.add_argument("--ranks", type=int, default=4)
    g.add_argument("--vertices", type=int, default=20_000)
    g.add_argument("--degree", type=int, default=10)
    g.add_argument("--classes", type=int, default=16)
    g.add_argument("--feat-dim", type=int, default=64)
    g.add_argument("--hidden", type=int, default=128)
    g.add_argument("--layers", type=int, default=2,
                   help="GNN layers; --fanouts must list one per layer")
    g.add_argument("--fanouts", type=int, nargs="+", default=[5, 10])
    g.add_argument("--batch", type=int, default=256)
    g.add_argument("--epochs", type=int, default=5)
    g.add_argument("--lr", type=float, default=0.006)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--hec-size", type=int, default=65536)
    g.add_argument("--hec-nc", type=int, default=512)
    g.add_argument("--hec-ls", type=int, default=2)
    g.add_argument("--hec-delay", type=int, default=1)
    g.add_argument("--ckpt", default=None,
                   help="save the trained params (flat .npz, the "
                        "reference's leaf order) to this path")
    g.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (plain PyTorch versions of "
                        "the kernels)")
    add_obs_flags(g)
    add_plane_flags(g, serving=False)
    return ap.parse_args(argv)


def save_params(path: str, model, step: int) -> str:
    """The params as ``repro/train/checkpoint.py:save`` writes them:
    ``leaf_<i>`` in the reference tree's leaf order and ``__step__``,
    streamed to ``<path>.tmp`` and moved into place."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {f"leaf_{i}": p.detach().cpu().numpy()
              for i, p in enumerate(model.parameter_list())}
    arrays["__step__"] = np.asarray(step)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return path


def gnn_config(args):
    """The GNN config the reference launcher builds from the arguments."""
    from repro_torch.configs.gnn import HECConfig, small_gnn_config
    return small_gnn_config(
        args.model, batch_size=args.batch, feat_dim=args.feat_dim,
        num_classes=args.classes, fanouts=tuple(args.fanouts),
        hidden_size=args.hidden, num_hidden_layers=args.layers - 1,
        lr=args.lr,
        hec=HECConfig(cache_size=args.hec_size, ways=8,
                      life_span=args.hec_ls, push_limit=args.hec_nc,
                      delay=args.hec_delay))


def run_gnn(args, pipeline=None, overlap: bool = True) -> dict:
    """The reference launcher's flow; returns what it built and measured
    (graph, partition, trainer, data, state, history, test accuracy,
    seconds, and with ``--trace-out`` the device summary).  ``pipeline``
    (a ``PipelineConfig``) and ``overlap`` (``DistTrainer.overlap``) have
    no flag, as in the reference."""
    from repro_torch.device import resolve_device
    from repro_torch.graph import partition_graph, synthetic_graph
    from repro_torch.train.gnn_trainer import DistTrainer, build_dist_data

    if len(args.fanouts) != args.layers:
        raise SystemExit(f"--fanouts lists {len(args.fanouts)} values for "
                         f"{args.layers} layers")
    device = resolve_device(args.device)
    configure_obs(args)
    prom = prom_writer(args)
    g = synthetic_graph(num_vertices=args.vertices, avg_degree=args.degree,
                        num_classes=args.classes, feat_dim=args.feat_dim,
                        seed=args.seed)
    print(f"graph: V={g.num_vertices} E={g.num_edges} "
          f"train={int(g.train_mask.sum())}")
    ps = partition_graph(g, args.ranks, seed=args.seed)
    print(f"partitioned into {args.ranks}: edge-cut={ps.edge_cut_frac:.3f} "
          f"solids={[p.num_solid for p in ps.parts]}")
    cfg = gnn_config(args)
    if pipeline is not None:
        cfg = dataclasses.replace(cfg, pipeline=pipeline)
    data = build_dist_data(ps, cfg, device)
    # the partition's halo rows per rank (ExchangePlan.
    # expected_inbound_rows) arm the edge-cut drift detector
    health, quality = build_planes(
        args, args.ranks, expected_halo_rows=[p.num_halo for p in ps.parts],
        prom=prom, quality_always=True)
    tr = DistTrainer(cfg=cfg, num_ranks=args.ranks, mode=args.mode,
                     device=device, overlap=overlap, health=health,
                     quality=quality)
    state = tr.init_state(seed=args.seed)
    with device_trace(args, device) as trace:
        t0 = time.time()
        state, hist = tr.train_epochs(ps, data, state, args.epochs,
                                      log_every=1)
        dt = time.time() - t0
        acc = tr.evaluate(ps, data, state)
    print(f"done: {args.epochs} epochs in {dt:.1f}s "
          f"({dt / args.epochs:.2f}s/epoch); test_acc={acc:.3f}")
    dev = report_device(trace, "training and evaluate", spans=("step",))
    print_health(health)
    qs = quality.summary()
    if qs["audits_run"]:
        print(f"quality:    audits={qs['audits_run']} last mean rel-L2 "
              f"err={qs['last_mean_err']} hidden={qs['last_hidden_err']}")
    finish_obs(prom)
    if args.ckpt:
        tr.join_push()
        save_params(args.ckpt, state["model"], state["step"])
        print("saved", args.ckpt)
    return {"graph": g, "ps": ps, "cfg": cfg, "trainer": tr, "data": data,
            "state": state, "history": hist, "test_acc": acc,
            "train_seconds": dt, "device_trace": dev, "health": health,
            "quality": quality}


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    run_gnn(args)


if __name__ == "__main__":
    main()
