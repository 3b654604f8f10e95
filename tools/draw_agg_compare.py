#!/usr/bin/env python3
"""Time the fanout draw (kernel I) and the AGG forward (kernel E) of two
versions of their sources on the card, in turns, at the shapes of
``chip_smoke.py``'s training paths, and pin E's outputs.

    PYTHONPATH=src python3 tools/draw_agg_compare.py [--parent DIR] [--sweep]

The shapes are those of the first minibatch of rank 0 on the paths of
``chip_smoke.py``: the 400,000-vertex synthetic graph cut into 4 parts,
batch 1000, fanouts 5/10/15, features 128 wide and hidden layers 256
wide.  I draws phase 7 (a)'s frontiers (the device-drawn cv minibatch of
epoch 0) under ``cv``, with weights 1 and 1 + ``cv_boost`` over a random
30% of rank 0's vertices in place of the trained HEC's residency; E takes
phase 4 (a)'s host-drawn minibatch, layer 0 reading its features and
layers 1 and 2 float32 normals in the shape of UPDATE's output.

Each version is a directory holding ``sample_draw.cu`` and
``sage_agg.cu``: the checkout's ``src/repro_torch/csrc`` ("change") and,
with ``--parent``, an older pair ("parent"), for instance from

    mkdir -p build/parent_csrc && for f in sample_draw sage_agg; do
      git show <commit>:src/repro_torch/csrc/$f.cu > build/parent_csrc/$f.cu
    done

Both are compiled by nvcc into ``build/compare/`` with the port's flags
and called through their C entries (the entry's arguments are read from
its source: the first designs take no form, the redesigned ones take
I's rows a tile and E's rows and column slice a warp).  Prints, for
each shape, each version's device ms in the order parent, change,
change, parent, and:

* I: every version bit-equal to the plain draw; the time with only the
  take-all rows allowed (``allow = deg <= f``) and with only the
  selection rows allowed (``allow = deg > f``), beside the whole;
* E: every version bit-equal to the first one (mean and count) and within
  1e-4 * max(1, |plain|) of the plain version; the SHA-256 of each
  version's mean and count bytes on the pinned inputs of ``PINNED_SHAPES``
  (``chip_smoke.E_PINNED`` and ``tests/test_torch_cuda.py`` hold them);
* with ``--sweep``, the change's I at every tile size and its E at
  every (rows, slices) form, each held bit-equal and timed.
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

OUT = os.path.join(ROOT, "build", "compare")
P, I = ctypes.c_void_p, ctypes.c_int
# (N, M, f, D) of E's pinned inputs: chip_smoke.E_PINNED's shapes (layer 0
# of the training path, the offline width of 77 slots at D 256, a ragged D
# = 6), then those of tests/test_torch_cuda.py::E_PINNED
PINNED_SHAPES = [(1_056_000, 176_000, 5, 128), (100_000, 2048, 77, 256),
                 (300, 37, 7, 6), (5000, 1000, 5, 128),
                 (3000, 1000, 15, 256), (1000, 257, 77, 100),
                 (100, 1, 1, 128), (200, 3, 15, 256), (500, 40, 1, 6)]


class Version:
    """One pair of sources, compiled and callable at a chosen form."""

    def __init__(self, tag: str, csrc: str):
        from repro_torch.kernels import _build
        self.tag = tag
        os.makedirs(OUT, exist_ok=True)
        procs = {}
        for name in ("sample_draw", "sage_agg"):
            src = os.path.join(csrc, f"{name}.cu")
            procs[name] = subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", csrc, "-o",
                 os.path.join(OUT, f"lib{tag}_{name}.so"), src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        with open(os.path.join(csrc, "sample_draw.cu")) as fh:
            self.grouped = re.search(r'"C" int sample_draw\([^)]*\bint group',
                                     fh.read()) is not None
        with open(os.path.join(csrc, "sage_agg.cu")) as fh:
            self.formed = re.search(r'"C" int sage_agg_fwd\([^)]*\bint rows',
                                    fh.read()) is not None
        self.libs = {}
        for name, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"{tag} {name}.cu: nvcc failed:\n{log}")
            print(f"{tag} {name}.cu ptxas: " + " | ".join(
                ln.strip() for ln in log.splitlines() if "registers" in ln
                or "spill" in ln))
            self.libs[name] = ctypes.CDLL(
                os.path.join(OUT, f"lib{tag}_{name}.so"))
        fn = self.libs["sample_draw"].sample_draw
        fn.argtypes = [P] * 6 + [I] * 4 + [ctypes.c_uint32, I] \
            + ([I] if self.grouped else []) + [P]
        fn.restype = I
        fn = self.libs["sage_agg"].sage_agg_fwd
        fn.argtypes = [P] * 5 + [I] * (6 if self.formed else 4) + [P]
        fn.restype = I

    def draw(self, torch, csr, cur, seed, allow, f, policy, group=None):
        from repro_torch.kernels import sample_draw as sd
        from repro_torch.kernels.ref import SAMPLE_POLICIES
        n = cur.shape[0]
        out = torch.empty((n, f), dtype=torch.int32, device=cur.device)
        form = []
        if self.grouped:
            sms = torch.cuda.get_device_properties(
                cur.device).multi_processor_count
            form = [sd.draw_group(n, sms) if group is None else group]
        rc = self.libs["sample_draw"].sample_draw(
            csr["indptr"].data_ptr(), csr["indices"].data_ptr(),
            csr["wtab"].data_ptr(), cur.data_ptr(),
            None if allow is None else allow.data_ptr(), out.data_ptr(), n,
            f, csr["num_solid"], csr["wtab"].shape[0], seed,
            SAMPLE_POLICIES.index(policy), *form,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.tag} sample_draw: CUDA error {rc}")
        return out

    def agg(self, torch, h, nbr, valid, form=None):
        from repro_torch.kernels import sage_agg as sa
        N, D = h.shape
        M, f = nbr.shape
        mean = torch.empty((M, D), dtype=torch.float32, device=h.device)
        cnt = torch.empty(M, dtype=torch.float32, device=h.device)
        extra = []
        if self.formed:
            sms = torch.cuda.get_device_properties(
                h.device).multi_processor_count
            extra = list(sa.agg_form(M, f, D, sms) if form is None
                         else form)
        rc = self.libs["sage_agg"].sage_agg_fwd(
            h.data_ptr(), nbr.data_ptr(), valid.data_ptr(), mean.data_ptr(),
            cnt.data_ptr(), N, M, f, D, *extra,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.tag} sage_agg_fwd: CUDA error {rc}")
        return mean, cnt


def path_shapes(torch, np, dev):
    """I's three cv layer inputs and E's three layer inputs (rank 0, the
    first minibatch of the training path)."""
    import dataclasses

    import chip_smoke as cs
    from repro_torch.configs.gnn import (HECConfig, SamplerConfig,
                                         small_gnn_config)
    from repro_torch.graph import partition_graph, synthetic_graph
    from repro_torch.pipeline.prefetcher import SamplingPlan
    from repro_torch.pipeline.threefry import draw_seed
    a = dict(zip(cs.TRAIN_ARGS[1::2], cs.TRAIN_ARGS[2::2]))
    fanouts = (5, 10, 15)
    g = synthetic_graph(num_vertices=cs.TRAIN_VERTICES,
                        avg_degree=int(a["--degree"]),
                        num_classes=int(a["--classes"]),
                        feat_dim=int(a["--feat-dim"]), seed=0)
    ps = partition_graph(g, 4, seed=0)
    cfg = small_gnn_config(
        "graphsage", batch_size=int(a["--batch"]),
        feat_dim=int(a["--feat-dim"]), num_classes=int(a["--classes"]),
        fanouts=fanouts, hidden_size=int(a["--hidden"]),
        num_hidden_layers=len(fanouts) - 1,
        hec=HECConfig(cache_size=int(a["--hec-size"]), ways=8,
                      push_limit=int(a["--hec-nc"])))
    part = ps.parts[0]
    rng = np.random.default_rng(0)
    mask = rng.random(part.num_solid + part.num_halo) < 0.3
    weights = 1.0 + cfg.pipeline.sampler.cv_boost * mask.astype(np.float32)
    csr = cs.card_csr(torch, np, part.indptr, part.indices, weights,
                      part.num_solid)
    cv = dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, sampler=SamplerConfig(policy="cv", device_draw=True)))
    plan = SamplingPlan(ps, cv, 0, device=dev)
    plan.set_cv_residency([np.zeros(p.vid_p_to_o().shape[0], bool)
                           for p in ps.parts])      # epoch 0's residency
    drawn = plan.sample_host(0, 0, plan.epoch_schedule(0)[0])
    draws = []
    for k in range(len(fanouts) - 1, -1, -1):
        cur = torch.as_tensor(
            drawn["layer_nodes"][k + 1][0].astype(np.int32), device=dev)
        draws.append((k, cur, fanouts[k], draw_seed(0, 0, 0, 0, k)))
    plan = SamplingPlan(ps, cfg, 0)
    host = plan.sample_host(0, 0, plan.epoch_schedule(0)[0])
    feats = torch.as_tensor(part.features, device=dev)
    nodes = [torch.as_tensor(n[0], device=dev) for n in host["layer_nodes"]]
    own = [torch.as_tensor(m[0], device=dev) & (n < part.num_solid)
           for n, m in zip(nodes, host["node_mask"])]
    gen = torch.Generator(device=dev).manual_seed(4)
    aggs = []
    for k in range(len(fanouts)):
        nbr = torch.as_tensor(host["nbr_idx"][k][0].astype(np.int32),
                              device=dev)
        if k == 0:
            h = feats[nodes[0].clamp(0, feats.shape[0] - 1).long()] \
                * own[0][:, None].float()
        else:
            h = torch.randn(aggs[-1][2].shape[0], int(a["--hidden"]),
                            generator=gen, device=dev)
        aggs.append((k, h.contiguous(), nbr, own[k]))
    return csr, draws, aggs


def degrees(torch, csr, cur):
    ip = csr["indptr"].long()
    valid = (cur >= 0) & (cur < csr["num_solid"])
    vc = torch.where(valid, cur.long(), 0)
    return torch.where(valid, ip[vc + 1] - ip[vc], 0)


def turns(versions):
    """parent, change, change, parent (or change twice alone)."""
    return versions + versions[::-1] if len(versions) > 1 else versions * 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None,
                    help="directory with the older sample_draw.cu and "
                         "sage_agg.cu")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ref
    if not torch.cuda.is_available():
        print("draw_agg_compare: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    versions = []
    if args.parent:
        versions.append(Version("parent", args.parent))
    versions.append(Version("change", os.path.join(
        ROOT, "src", "repro_torch", "csrc")))
    csr, draws, aggs = path_shapes(torch, np, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    # kernel I under cv: whole, take-all rows alone, selection rows alone
    for k, cur, f, seed in draws:
        deg = degrees(torch, csr, cur)
        want = ref.draw_neighbors(csr["indptr"], csr["indices"], csr["wtab"],
                                  cur, seed, None, f=f,
                                  num_solid=csr["num_solid"],
                                  width=csr["width"], policy="cv")
        halves = {"whole": None, "take-all": (deg <= f).contiguous(),
                  "selection": (deg > f).contiguous()}
        times = {(v.tag, h): [] for v in versions for h in halves}
        for v in versions:
            got = v.draw(torch, csr, cur, seed, None, f, "cv")
            cs.check(torch.equal(got, want), f"{v.tag} I layer {k} differs "
                     f"from the plain draw")
        for v in turns(versions):
            for h, allow in halves.items():
                times[v.tag, h].append(cs.time_ms(
                    torch, lambda: v.draw(torch, csr, cur, seed, allow, f,
                                          "cv"), iters=50)[0])
        print(f"I layer {k}: cur {cur.shape[0]}, f {f}, "
              f"{int(deg.sum())} candidates, {int((deg > f).sum())} "
              f"selection rows, degree <= {int(deg.max())}: " + "; ".join(
                  f"{tag} " + ", ".join(
                      f"{h} " + "/".join(f"{t:.5f}" for t in times[tag, h])
                      for h in halves)
                  for tag in dict.fromkeys(v.tag for v in versions)))
        if args.sweep:
            change = versions[-1]
            for group in (1, 2, 4, 8, 16, 32):
                got = change.draw(torch, csr, cur, seed, None, f, "cv", group)
                cs.check(torch.equal(got, want), f"I layer {k} rows per "
                         f"warp {group} differs from the plain draw")
                t = cs.time_ms(torch, lambda: change.draw(
                    torch, csr, cur, seed, None, f, "cv", group), iters=50)[0]
                print(f"  sweep I layer {k}: tiles of {group} rows: {t:.5f}")

    # kernel E at the layer shapes
    for k, h, nbr, valid in aggs:
        want, want_cnt = ref.sage_agg_ref(h, nbr, valid)
        first = None
        for v in versions:
            mean, cnt = v.agg(torch, h, nbr, valid)
            ok, err = cs.close_to(mean, want)
            cs.check(ok and torch.equal(cnt, want_cnt),
                     f"{v.tag} E layer {k}: {err:.3e} from the plain version")
            if first is None:
                first = (mean, cnt)
            cs.check(torch.equal(mean, first[0])
                     and torch.equal(cnt, first[1]),
                     f"{v.tag} E layer {k} is not bit-equal to "
                     f"{versions[0].tag}")
        times = {v.tag: [] for v in versions}
        for v in turns(versions):
            times[v.tag].append(cs.time_ms(
                torch, lambda: v.agg(torch, h, nbr, valid), iters=50)[0])
        M, f = nbr.shape
        print(f"E layer {k}: h {h.shape[0]}x{h.shape[1]}, nbr {M}x{f}: "
              + "; ".join(f"{tag} " + "/".join(f"{t:.5f}" for t in ts)
                          for tag, ts in times.items())
              + " (bit-equal across versions)")
        if args.sweep:
            change = versions[-1]
            D = h.shape[1]
            for rows in (1, 2, 3, 4, 6, 8, 16):
                for slices in range(1, max(1, -(-D // 128)) + 1):
                    form = (rows, -(-(-(-D // slices)) // 128) * 128)
                    mean, cnt = change.agg(torch, h, nbr, valid, form)
                    cs.check(torch.equal(mean, first[0])
                             and torch.equal(cnt, first[1]),
                             f"E layer {k} form {form} is not bit-equal")
                    t = cs.time_ms(torch, lambda: change.agg(
                        torch, h, nbr, valid, form), iters=50)[0]
                    print(f"  sweep E layer {k}: rows {rows}, slice "
                          f"{form[1]}: {t:.5f}")

    # E's pinned outputs
    for shape in PINNED_SHAPES:
        hn, nn, vn = cs.pinned_agg_inputs(np, *shape)
        h, nbr = torch.as_tensor(hn, device=dev), torch.as_tensor(nn,
                                                                  device=dev)
        valid = torch.as_tensor(vn, device=dev)
        got = [cs.agg_digest(*v.agg(torch, h, nbr, valid))
               for v in versions]
        cs.check(len(set(got)) == 1, f"E pinned {shape}: the versions "
                 f"differ: {got}")
        print(f"E pinned (N, M, f, D) = {shape}: {got[0]}")
    print(f"draw_agg_compare: done on {sms} SMs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
