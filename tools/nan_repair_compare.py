#!/usr/bin/env python3
"""Time kernels C, A, E, G and H of the checkout against an older set of
sources in one call on the card, and hold the two to the same bits.

    PYTHONPATH=src python3 tools/nan_repair_compare.py --parent DIR

``DIR`` holds the older ``csrc/`` (every ``.cu`` and ``.cuh``), for
instance ``git archive <commit> src/repro_torch/csrc | tar -x -C DIR``
and then ``DIR/src/repro_torch/csrc``.  Both sets have the same C
entries and the wrappers are the checkout's, so one process loads both
builds (``_build`` pointed at each directory in turn) and calls the same
wrappers (H's slot index built beforehand).  Shapes: E at the training
path's three layers (rank 0's first minibatch,
``tools/draw_agg_compare.py:path_shapes``; at that step every halo is
excluded, the HEC being empty), C at the UPDATE shapes those layers
feed, G and H at GAT's on the same neighbor lists (4 heads of 256, then
one of 172), A at phase 3's serve layer shapes with 20% invalid sources
and 5% pads.  Prints per shape the device ms of parent, change,
change, parent (``chip_smoke.time_ms``) and whether the change's output
is the parent's bit for bit.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tools"))

NAMES = ("update_fused", "serve_fused", "sage_agg", "gat_edge")


def load_version(csrc: str, warm) -> dict:
    """Build and load every source of ``csrc`` (the checkout's build
    directory, a digest of their own) and return the loaded libraries."""
    from repro_torch.kernels import _build
    _build.CSRC = Path(csrc)
    _build._libs = {}
    _build.build(NAMES)
    warm()
    return dict(_build._libs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="directory with the older csrc sources")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    import chip_smoke as cs
    from draw_agg_compare import path_shapes
    from repro_torch.kernels import _build
    from repro_torch.kernels import gat_edge as ge
    from repro_torch.kernels import sage_agg as sa
    from repro_torch.kernels import serve_fused as sf
    from repro_torch.kernels import update_fused as uf
    from repro_torch.kernels.slot_index import slot_index
    if not torch.cuda.is_available():
        print("nan_repair_compare: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    gen = torch.Generator(device=dev).manual_seed(7)

    def normal(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale
    _, _, aggs = path_shapes(torch, np, dev)
    cases = []
    for k, h, nbr, valid in aggs:
        M, D = nbr.shape[0], h.shape[1]
        K = 172 if k == len(aggs) - 1 else 256
        cases.append((f"E layer {k} ({M}x{nbr.shape[1]}x{D})",
                      lambda h=h, nbr=nbr, valid=valid:
                      sa.sage_agg_fwd(h, nbr, valid)))
        upd = dict(agg=normal(M, D), self_h=normal(M, D),
                   wn=normal(D, K, scale=0.1), ws=normal(D, K, scale=0.1),
                   b=normal(K, scale=0.1))
        cases.append((f"C layer {k} ({M}x{D}->{K})",
                      lambda upd=upd: uf.update_fused_fwd(
                          relu=True, dropout=0.1, seed=3, **upd)))
        H, dh = (1, 172) if k == len(aggs) - 1 else (4, 256)
        gat = dict(z=normal(h.shape[0], H, dh), e_u=normal(h.shape[0], H),
                   e_v=normal(M, H), nbr_idx=nbr, src_valid=valid)
        g = normal(M, H * dh)
        index = slot_index(nbr, valid, h.shape[0])
        cases.append((f"G layer {k} ({M}x{nbr.shape[1]}x{H}x{dh})",
                      lambda gat=gat: ge.gat_edge_fwd(**gat)))
        cases.append((f"H layer {k} ({M}x{nbr.shape[1]}x{H}x{dh})",
                      lambda gat=gat, g=g, index=index: ge.gat_edge_bwd(
                          g, **gat, index=index)))
    rng = np.random.default_rng(3)
    for N, M, f, D, K in ((67_584, 11_264, 5, 128, 256),
                          (11_264, 2048, 10, 256, 256),
                          (2048, 64, 15, 256, 172)):
        nbr = rng.integers(0, N, (M, f)).astype(np.int32)
        nbr[rng.random((M, f)) < 0.05] = -1
        serve = dict(h_src=normal(N, D),
                     nbr_idx=torch.as_tensor(nbr, device=dev),
                     src_valid=torch.as_tensor(rng.random(N) > 0.2,
                                               device=dev),
                     wn=normal(D, K, scale=0.1), ws=normal(D, K, scale=0.1),
                     b=normal(K, scale=0.1))
        cases.append((f"A ({M}x{f}x{D}->{K})",
                      lambda serve=serve: sf.serve_fused_layer(
                          relu=True, **serve)))

    def warm():
        for _, fn in cases:
            fn()
        torch.cuda.synchronize()
    versions = {
        "parent": load_version(args.parent, warm),
        "change": load_version(os.path.join(ROOT, "src", "repro_torch",
                                            "csrc"), warm)}

    def outputs(fn):
        out = fn()
        return list(out) if isinstance(out, tuple) else [out]
    for name, fn in cases:
        got = {}
        for tag, libs in versions.items():
            _build._libs = libs
            got[tag] = outputs(fn)
        same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(got["parent"], got["change"]))
        times = {tag: [] for tag in versions}
        for tag in ("parent", "change", "change", "parent"):
            _build._libs = versions[tag]
            times[tag].append(cs.time_ms(torch, fn)[0])
        ratio = sum(times["change"]) / sum(times["parent"])
        print(f"{name}: parent " + "/".join(
            f"{t:.6f}" for t in times["parent"]) + " ms, change "
            + "/".join(f"{t:.6f}" for t in times["change"])
            + f" ms, change/parent {ratio:.3f}; bit-equal {same}")
        del got
    return 0


if __name__ == "__main__":
    sys.exit(main())
