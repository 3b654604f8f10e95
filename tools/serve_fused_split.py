#!/usr/bin/env python3
"""Time the serve-layer kernel (kernel A) whole, its gather alone and its
products alone, on the card, at three shapes of ``chip_smoke.py``'s phase
1: serve layers 0 and 2 of a 64-slot microbatch and the first offline
chunk of layer 1 (2,048 dst rows, full neighbor lists of width 77), all on
the 100,000-vertex graph at the graphsage-papers100m widths.

    PYTHONPATH=src python3 tools/serve_fused_split.py [--source FILE ...]

Each ``--source`` (default: the checkout's ``csrc/serve_fused.cu``) is
compiled three times into ``build/split/``: as it is, with
``-DPRODUCT_ONLY`` (the code from its ``// 1. gather`` comment up to its
``// 2. both products`` comment left out: the products run on whatever the
shared tiles hold) and with ``-DGATHER_ONLY`` (the kernel returns at ``//
2. both products``, after writing one value so that the gather is kept).
The variants exist only in the copies this script writes; the source it
reads is not changed.  Both the first design of the kernel (FFMA products,
no block form) and the tensor-core one (``bm``, ``col_tiles``) are taken;
an older source can be had with ``git show <commit>:src/repro_torch/csrc/
serve_fused.cu > build/old_serve_fused.cu``.  Prints the card's name and
power limit, then one line per source and shape: ms whole, gather alone,
products alone (device time, ``chip_smoke.time_ms``).
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

GATHER = "  // 1. gather"
PRODUCTS = "  // 2. both products"
SPLIT_OUT = os.path.join(ROOT, "build", "split")


def variants(src: str) -> str:
    """The source with the PRODUCT_ONLY and GATHER_ONLY switches put in."""
    lines = src.splitlines(keepends=True)
    g = next(i for i, ln in enumerate(lines) if ln.startswith(GATHER))
    p = next(i for i, ln in enumerate(lines) if ln.startswith(PRODUCTS))
    early = ("#ifdef GATHER_ONLY\n"
             "  if (threadIdx.x == 0 && m0 < M)\n"
             "    out[(size_t)m0 * K] = agg_s[0] + self_s[0];\n"
             "  asm volatile(\"cp.async.wait_all;\\n\" ::);\n"
             "  return;\n"
             "#endif\n")
    return "".join(lines[:g] + ["#ifndef PRODUCT_ONLY\n"] + lines[g:p]
                   + ["#endif\n", early] + lines[p:])


def build(path: str, tag: str):
    """{variant: loaded library} of the three builds of ``path``."""
    from repro_torch.kernels import _build
    os.makedirs(SPLIT_OUT, exist_ok=True)
    with open(path) as fh:
        src = fh.read()
    tiled = re.search(r"\bint bm,", src) is not None
    cu = os.path.join(SPLIT_OUT, f"{tag}.cu")
    with open(cu, "w") as fh:
        fh.write(variants(src))
    flags = {"whole": [], "gather": ["-DGATHER_ONLY"],
             "product": ["-DPRODUCT_ONLY"]}
    procs = {v: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, *fl,
         "-I", str(_build.CSRC), "-o",
         os.path.join(SPLIT_OUT, f"lib{tag}_{v}.so"), cu],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for v, fl in flags.items()}
    libs = {}
    P, I = ctypes.c_void_p, ctypes.c_int
    for v, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{path} ({v}): nvcc failed:\n{log}")
        lib = ctypes.CDLL(os.path.join(SPLIT_OUT, f"lib{tag}_{v}.so"))
        lib.serve_fused_layer.argtypes = [P] * 8 + [I] * (8 if tiled else 6) \
            + [P]
        lib.serve_fused_layer.restype = I
        libs[v] = lib
    return libs, tiled


def shapes(torch, np, dev):
    """(name, h, nbr, valid, layer, relu, self_idx) at the three shapes."""
    import chip_smoke as cs
    from repro_torch.graph import partition_graph, synthetic_graph
    from repro_torch.kernels import ref
    from repro_torch.launch.gnn_serve import model_config
    from repro_torch.models.gnn.graphsage import GraphSAGE
    from repro_torch.pipeline.vectorized_sampler import \
        sample_blocks_vectorized
    from repro_torch.serve.gnn import full_neighbor_matrix
    cfg = model_config("graphsage-papers100m")
    g = synthetic_graph(num_vertices=100_000, avg_degree=8,
                        num_classes=cfg.num_classes, feat_dim=cfg.feat_dim,
                        seed=0)
    part = partition_graph(g, 1, seed=0).parts[0]
    model = GraphSAGE.from_config(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    seeds = rng.choice(part.num_solid, size=cs.SLOTS, replace=False)
    blocks = sample_blocks_vectorized(part, seeds, cfg.fanouts,
                                      np.random.default_rng([0, 0]), cs.SLOTS)
    feats = torch.as_tensor(part.features, device=dev)
    valid = torch.as_tensor(blocks.node_mask[0], device=dev)
    h = feats[torch.as_tensor(blocks.layer_nodes[0], device=dev).clamp(
        0, part.num_solid - 1)] * valid[:, None]
    out = []
    L = model.num_layers
    for k, layer in enumerate(model.layers):
        nbr = torch.as_tensor(blocks.nbr_idx[k], dtype=torch.int32,
                              device=dev)
        if k in (0, L - 1):
            out.append((f"serve l{k}", h, nbr, valid, layer, k < L - 1,
                        None))
        h = ref.serve_layer_ref(h, nbr, valid, layer.wn, layer.ws, layer.b,
                                relu=k < L - 1)
        valid = torch.as_tensor(blocks.node_mask[k + 1], device=dev)
    nbr_full = torch.as_tensor(full_neighbor_matrix(part), dtype=torch.int32,
                               device=dev)
    h1 = cs.plain_offline_layer(torch, ref, feats, nbr_full, model.layers[0],
                                True)
    out.append(("offline chunk l1", h1,
                nbr_full[:cs.OFFLINE_CHUNK].contiguous(),
                torch.ones(part.num_solid, dtype=torch.bool, device=dev),
                model.layers[1], True,
                torch.arange(cs.OFFLINE_CHUNK, dtype=torch.int32,
                             device=dev)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", default=None)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("serve_fused_split: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import serve_fused as sf
    sources = args.source or [str(_build.CSRC / "serve_fused.cu")]
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(f"card: {smi.stdout.strip().splitlines()[0]}")
    built = [(path, *build(path, f"src{i}")) for i, path in
             enumerate(sources)]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.no_grad():
        for name, h, nbr, valid, layer, relu, self_idx in shapes(torch, np,
                                                                 dev):
            N, D = h.shape
            M, f = nbr.shape
            K = layer.wn.shape[1]
            out = torch.empty(M, K, device=dev)
            want = ref.serve_layer_ref(h, nbr, valid, layer.wn, layer.ws,
                                       layer.b, relu=relu, self_idx=self_idx)
            for path, libs, tiled in built:
                form = list(sf.serve_tile(M, K, D, sms)) if tiled else []
                argv_ = [h.data_ptr(), nbr.data_ptr(), valid.data_ptr(),
                         layer.wn.data_ptr(), layer.ws.data_ptr(),
                         layer.b.data_ptr(),
                         None if self_idx is None else self_idx.data_ptr(),
                         out.data_ptr(), N, M, f, D, K, int(relu), *form,
                         stream]
                ms = {}
                for v, lib in libs.items():
                    rc = lib.serve_fused_layer(*argv_)
                    if rc != 0:
                        raise RuntimeError(f"{path} ({v}): CUDA error {rc}")
                    torch.cuda.synchronize()
                    if v == "whole":
                        ok, err = cs.close_to(out, want)
                        if not ok:
                            raise RuntimeError(f"{path}: {name} off the "
                                               f"plain version by {err:.3e}")
                    ms[v], _ = cs.time_ms(
                        torch, lambda lib=lib: lib.serve_fused_layer(*argv_))
                print(f"{os.path.relpath(path, ROOT)}: {name} (h {N}x{D}, "
                      f"nbr {M}x{f}, W {D}x{K}"
                      + (f", form {tuple(form)}" if form else "")
                      + f"): whole {ms['whole']:.4f} ms, gather alone "
                      f"{ms['gather']:.4f}, products alone "
                      f"{ms['product']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
