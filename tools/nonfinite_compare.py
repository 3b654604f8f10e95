#!/usr/bin/env python3
"""Time kernels F, H, C and A of the checkout against an older set of
sources in one call on the card, on finite inputs, and hold the two to
the same bits.

    PYTHONPATH=src python3 tools/nonfinite_compare.py --parent DIR

``DIR`` holds the older ``csrc/`` (every ``.cu`` and ``.cuh``), for
instance ``git archive <commit> src/repro_torch/csrc | tar -x -C DIR``
and then ``DIR/src/repro_torch/csrc``.  One process loads both builds
(``_build`` pointed at each directory in turn) and calls the checkout's
wrappers; F's C entry took fewer operands before the masked slots' 0 * g
(no neighbor list, no M), so the older F is called through its own
signature.  Shapes, as ``tools/nan_repair_compare.py``'s: F at the
training path's layers 1 and 2 (rank 0's first minibatch,
``tools/draw_agg_compare.py:path_shapes``), H at GAT's on the same
neighbor lists (4 heads of 256, then one of 172), C at the UPDATE shapes
of the three layers, A at phase 3's serve layers.  The slot indices are
built beforehand (their build is the same in both).  Prints per shape the
device ms of parent, change, change, parent (``chip_smoke.time_ms``) and
whether the change's output is the parent's bit for bit.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tools"))

NAMES = ("update_fused", "serve_fused", "sage_agg", "gat_edge")
_P, _I = ctypes.c_void_p, ctypes.c_int


def load_version(csrc: str) -> dict:
    """Build every source of ``csrc`` (the checkout's build directory, a
    digest of their own) and return the libraries, unloaded."""
    from repro_torch.kernels import _build
    _build.CSRC = Path(csrc)
    _build._libs = {}
    _build.build(NAMES)
    return {name: _build.library_path(name) for name in NAMES}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="directory with the older csrc sources")
    ap.add_argument("--change", default=os.path.join(ROOT, "src",
                                                     "repro_torch", "csrc"),
                    help="directory with the newer sources (default: the "
                         "checkout's)")
    ap.add_argument("--only", default="FHCA",
                    help="the kernels to time, of F, H, C and A")
    ap.add_argument("--ptxas-out", default=None, metavar="PATH",
                    help="write both builds' ptxas reports (registers, "
                         "spills) here")
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
        print("nonfinite_compare: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    gen = torch.Generator(device=dev).manual_seed(7)

    def normal(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    paths, logs = {}, []
    for tag, csrc in (("parent", args.parent), ("change", args.change)):
        paths[tag] = load_version(csrc)
        logs += [f"== {tag} {name}\n{_build.build_logs.get(name, '')}"
                 for name in NAMES]
    if args.ptxas_out:
        Path(args.ptxas_out).write_text("\n".join(logs))
    signatures = {"update_fused": uf._SIGNATURES,
                  "serve_fused": sf._SIGNATURES, "sage_agg": sa._SIGNATURES,
                  "gat_edge": ge._SIGNATURES}
    versions = {}
    for tag, libs in paths.items():
        versions[tag] = {}
        for name, path in libs.items():
            lib = ctypes.CDLL(str(path))
            for fn, (argtypes, restype) in signatures[name].items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = restype
            versions[tag][name] = lib
    old_f = versions["parent"]["sage_agg"].sage_agg_bwd
    old_f.argtypes = [_P] * 8 + [_I] * 4 + [_P]

    def parent_f(g, nbr, valid, cnt, N, index):
        D = g.shape[1]
        dh = torch.empty((N, D), dtype=torch.float32, device=dev)
        part = torch.empty((index.lbound, D), dtype=torch.float32,
                           device=dev)
        ticket = torch.zeros(index.lbound, dtype=torch.int32, device=dev)
        rc = old_f(g.data_ptr(), cnt.data_ptr(), index.offsets.data_ptr(),
                   index.slots.data_ptr(), index.lbase.data_ptr(),
                   part.data_ptr(), ticket.data_ptr(), dh.data_ptr(), N,
                   nbr.shape[1], D, index.lbound,
                   torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"parent sage_agg_bwd: CUDA error {rc}")
        return dh

    _build._libs = dict(versions["change"])
    _build.CSRC = Path(__file__).resolve().parents[1] / "src" / \
        "repro_torch" / "csrc"
    _, _, aggs = path_shapes(torch, np, dev)
    cases = []                        # (name, parent fn, change fn)
    for k, h, nbr, valid in aggs:
        M, D, N = nbr.shape[0], h.shape[1], h.shape[0]
        K = 172 if k == len(aggs) - 1 else 256
        if k > 0:
            g = normal(M, D)
            cnt = sa.sage_agg_fwd(h, nbr, valid)[1]
            index = slot_index(nbr, valid, N)
            cases.append((
                f"F layer {k} ({M}x{nbr.shape[1]}x{D} -> {N})",
                lambda g=g, nbr=nbr, valid=valid, cnt=cnt, N=N, ix=index:
                parent_f(g, nbr, valid, cnt, N, ix),
                lambda g=g, nbr=nbr, valid=valid, cnt=cnt, N=N, ix=index:
                sa.sage_agg_bwd(g, nbr, valid, cnt, N, ix)))
        upd = dict(agg=normal(M, D), self_h=normal(M, D),
                   wn=normal(D, K, scale=0.1), ws=normal(D, K, scale=0.1),
                   b=normal(K, scale=0.1))
        fn = (lambda upd=upd: uf.update_fused_fwd(relu=True, dropout=0.1,
                                                  seed=3, **upd))
        cases.append((f"C layer {k} ({M}x{D}->{K})", fn, fn))
        H, dh = (1, 172) if k == len(aggs) - 1 else (4, 256)
        gat = dict(z=normal(N, H, dh), e_u=normal(N, H), e_v=normal(M, H),
                   nbr_idx=nbr, src_valid=valid)
        g = normal(M, H * dh)
        index = slot_index(nbr, valid, N)
        fn = (lambda gat=gat, g=g, ix=index: ge.gat_edge_bwd(g, **gat,
                                                             index=ix))
        cases.append((f"H layer {k} ({M}x{nbr.shape[1]}x{H}x{dh})", fn, fn))
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
        fn = (lambda serve=serve: sf.serve_fused_layer(relu=True, **serve))
        cases.append((f"A ({M}x{f}x{D}->{K})", fn, fn))

    def outputs(fn):
        out = fn()
        return list(out) if isinstance(out, tuple) else [out]
    for name, fn_parent, fn_change in cases:
        if name[0] not in args.only:
            continue
        fns = {"parent": fn_parent, "change": fn_change}
        got = {}
        for tag in fns:
            _build._libs = dict(versions[tag])
            got[tag] = outputs(fns[tag])
        same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(got["parent"], got["change"]))
        times = {tag: [] for tag in fns}
        for tag in ("parent", "change", "change", "parent"):
            _build._libs = dict(versions[tag])
            times[tag].append(cs.time_ms(torch, fns[tag])[0])
        ratio = sum(times["change"]) / sum(times["parent"])
        print(f"{name}: parent " + "/".join(
            f"{t:.6f}" for t in times["parent"]) + " ms, change "
            + "/".join(f"{t:.6f}" for t in times["change"])
            + f" ms, change/parent {ratio:.3f}; bit-equal {same}",
            flush=True)
        del got
    return 0


if __name__ == "__main__":
    sys.exit(main())
