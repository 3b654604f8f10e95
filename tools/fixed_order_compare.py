#!/usr/bin/env python3
"""Time the AGG gradient (kernel F) and the GAT AGG gradient (kernel H)
of the checkout against an older pair of sources in one call on the card,
at the training paths' shapes.

    PYTHONPATH=src python3 tools/fixed_order_compare.py --parent DIR

The shapes are those of the first minibatch of rank 0 of
``chip_smoke.py``'s training paths (``tools/draw_agg_compare.py:
path_shapes``): F at phase 4's layers 1 and 2 (D 256), H at phase 6's
layers 0-2 (4 heads of 256, then one of 172), with ``g``, ``z``, ``e_u``
and ``e_v`` float32 normals and E's neighbor counts.  ``DIR`` holds the
older ``sage_agg.cu`` and ``gat_edge.cu`` (the atomic scatters, whose C
entries take the neighbor matrix and zeroed outputs), for instance from

    mkdir -p build/parent_csrc && for f in sage_agg gat_edge; do
      git show <commit>:src/repro_torch/csrc/$f.cu > build/parent_csrc/$f.cu
    done

The older pair is compiled by nvcc into ``build/compare/`` with the
port's flags and called through its C entries (with the output zeroing
its callers did); the checkout's kernels are called through their
wrappers with the slot index built beforehand, and the index build is
timed apart.  Prints, per shape, the device ms of parent, change,
change, parent, each version's spread from run to run over three
launches (bit-equal or the largest difference), and the change within
tolerance of the parent.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tools"))

OUT = os.path.join(ROOT, "build", "compare")
P, I = ctypes.c_void_p, ctypes.c_int


class Parent:
    """The older sources' F and H, each a zeroing plus one launch."""

    def __init__(self, csrc: str):
        from repro_torch.kernels import _build
        os.makedirs(OUT, exist_ok=True)
        self.libs = {}
        procs = {n: subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", csrc, "-o",
             os.path.join(OUT, f"libparent_{n}.so"),
             os.path.join(csrc, f"{n}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for n in ("sage_agg", "gat_edge")}
        for n, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"parent {n}.cu: nvcc failed:\n{log}")
            self.libs[n] = ctypes.CDLL(os.path.join(OUT,
                                                    f"libparent_{n}.so"))
        fn = self.libs["sage_agg"].sage_agg_bwd
        fn.argtypes, fn.restype = [P] * 5 + [I] * 4 + [P], I
        fn = self.libs["gat_edge"].gat_edge_bwd
        fn.argtypes, fn.restype = [P] * 11 + [I] * 6 + [P], I

    def f(self, torch, g, nbr, valid, cnt, N):
        M, f = nbr.shape
        dh = torch.zeros((N, g.shape[1]), device=g.device)
        rc = self.libs["sage_agg"].sage_agg_bwd(
            g.data_ptr(), nbr.data_ptr(), valid.data_ptr(), cnt.data_ptr(),
            dh.data_ptr(), N, M, f, g.shape[1],
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"parent sage_agg_bwd: CUDA error {rc}")
        return dh

    def h(self, torch, g, z, e_u, e_v, nbr, valid):
        N, H, dh = z.shape
        M, f = nbr.shape
        dev = z.device
        dz = torch.zeros((N, H, dh), device=dev)
        deu = torch.zeros((N, H), device=dev)
        dev_ = torch.zeros((e_v.shape[0], H), device=dev)
        da = torch.empty((M, f, H), device=dev)
        rc = self.libs["gat_edge"].gat_edge_bwd(
            g.data_ptr(), z.data_ptr(), e_u.data_ptr(), e_v.data_ptr(),
            nbr.data_ptr(), valid.data_ptr(), None, da.data_ptr(),
            dz.data_ptr(), deu.data_ptr(), dev_.data_ptr(), N,
            e_v.shape[0], M, f, H, dh,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"parent gat_edge_bwd: CUDA error {rc}")
        return dz, deu, dev_


def spread(torch, fn):
    """0.0 when three calls give the same bits, else the largest
    difference between them."""
    outs = [fn() for _ in range(3)]
    outs = [o if isinstance(o, tuple) else (o,) for o in outs]
    return max(float((a - b).abs().max()) for o in outs[1:]
               for a, b in zip(outs[0], o))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="directory with the older sage_agg.cu and "
                         "gat_edge.cu")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    import chip_smoke as cs
    from draw_agg_compare import path_shapes
    from repro_torch.kernels import gat_edge as ge
    from repro_torch.kernels import sage_agg as sa
    from repro_torch.kernels import slot_index as si
    if not torch.cuda.is_available():
        print("fixed_order_compare: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    parent = Parent(args.parent)
    _, _, aggs = path_shapes(torch, np, dev)
    gen = torch.Generator(device=dev).manual_seed(7)

    def turns(name, versions):
        times = {tag: [] for tag in versions}
        for tag in list(versions) + list(versions)[::-1]:
            times[tag].append(cs.time_ms(torch, versions[tag])[0])
        print(f"{name}: device ms " + ", ".join(
            f"{tag} {' / '.join(f'{t:.4f}' for t in ts)}"
            for tag, ts in times.items()))

    for k, h, nbr, valid in aggs[1:]:
        N, D = h.shape
        M = nbr.shape[0]
        _, cnt = sa.sage_agg_fwd(h, nbr, valid)
        g = torch.randn(M, D, generator=gen, device=dev)
        ix = si.slot_index(nbr, valid, N)
        name = f"F layer {k} (g {M}x{D}, nbr {M}x{nbr.shape[1]}, dh {N}x{D})"
        new = lambda: sa.sage_agg_bwd(g, nbr, valid, cnt, N, ix)  # noqa
        old = lambda: parent.f(torch, g, nbr, valid, cnt, N)      # noqa
        ok, err = cs.close_to(new(), old())
        cs.check(ok, f"{name}: change and parent part by {err:.3e}")
        print(f"{name}: spread over 3 launches: change {spread(torch, new)}"
              f", parent {spread(torch, old)}; |change - parent| {err:.3e}")
        turns(name, {"parent": old, "change": new})
        print(f"{name}: slot index build "
              f"{cs.time_ms(torch, lambda: si.slot_index(nbr, valid, N))[0]:.4f}"
              f" ms")
    for k, h, nbr, valid in aggs:
        N = h.shape[0]
        M = nbr.shape[0]
        H, dh = (4, 256) if k < len(aggs) - 1 else (1, 172)
        z = torch.randn(N, H, dh, generator=gen, device=dev)
        e_u = torch.randn(N, H, generator=gen, device=dev)
        e_v = torch.randn(N, H, generator=gen, device=dev)
        g = torch.randn(M, H * dh, generator=gen, device=dev)
        ix = si.slot_index(nbr, valid, N)
        name = f"H layer {k} (g {M}x{H * dh}, nbr {M}x{nbr.shape[1]}, " \
            f"z {N}x{H}x{dh})"
        new = lambda: ge.gat_edge_bwd(g, z, e_u, e_v, nbr, valid,  # noqa
                                      index=ix)
        old = lambda: parent.h(torch, g, z, e_u, e_v, nbr, valid)  # noqa
        errs = [cs.close_to(a, b) for a, b in zip(new(), old())]
        cs.check(all(ok for ok, _ in errs), f"{name}: change and parent "
                 f"part by {[e for _, e in errs]}")
        print(f"{name}: spread over 3 launches: change {spread(torch, new)}"
              f", parent {spread(torch, old)}; |change - parent| "
              f"{max(e for _, e in errs):.3e}")
        turns(name, {"parent": old, "change": new})
        print(f"{name}: slot index build "
              f"{cs.time_ms(torch, lambda: si.slot_index(nbr, valid, N))[0]:.4f}"
              f" ms")
        del z, e_u, e_v, g
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
