"""What one training step of the port costs, per rank: its operations,
its bytes and its collective schedule (counterpart of
``repro/utils/hlo_cost.py`` and ``repro/utils/hlo.py``, which read them
from the step's XLA HLO; torch has no HLO, so the step is run once and
counted).

* **Hand-written kernels** are counted per launch by their work formulas
  (the ``*_work`` functions below; each wrapper is decorated with
  :func:`counted` and records its own calls): the bytes the function must move
  (each input read once, each output written once) and the operations it
  does, on the CUDA cores in float32 (``fp32``) and on the tensor cores
  in TF32 (``tf32``, three TF32 products per float32-accurate 3xTF32
  product).  ``chip_smoke.py`` feeds the same formulas to :func:`bound`,
  so its kernel table and the dry run's roofline agree.  Where the work
  depends on the data (kept slots, rows read once) the formula counts
  what these inputs need.  On the CPU the wrappers run their plain
  versions; those are counted by the kernel's formula too (their own
  torch ops are not), so the CPU and the card give the same counts.
* **Products outside the kernels** (GAT's projection ``addmm`` and its
  attention product, the backward's weight and input products): every
  ``mm``/``addmm``/``bmm`` the step runs outside a kernel wrapper, by its
  shapes: ``2 m n k`` operations (float32, ``fp32``), its operands read
  and its output written once.
* **Collectives**: the step's ``all_to_all`` and ``psum`` calls on the
  trainer's collective with the bytes one rank receives
  (``StackedCollective.record``), under the reference's names
  ``all-to-all`` and ``all-reduce``.

Elementwise torch ops (the HEC substitution, the loss, Adam, the push's
selection) are not counted: the reference's ``flops`` counts dot products
only, and its ``bytes_accessed`` every fused op.  ``flops`` here is each
kernel's arithmetic (``fp32 + tf32 / 3``) plus the products'.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.mesh import HBM_BW, PEAK_FP32_FLOPS, PEAK_TF32_FLOPS


@dataclasses.dataclass
class Work:
    """One launch's least work: ``nbytes`` moved, ``fp32`` operations on
    the CUDA cores, ``tf32`` on the tensor cores; ``ffma``, where the
    kernel takes the tensor cores, the operations the same function needs
    in float32 FFMA alone."""
    nbytes: float
    fp32: float
    tf32: float = 0.0
    ffma: Optional[float] = None

    @property
    def flops(self) -> float:
        """The arithmetic: a 3xTF32 product issues three TF32 products."""
        return self.fp32 + self.tf32 / 3.0


def bound(work: Work) -> Tuple[float, str]:
    """``(ms, "bytes" | "operations")``: the least time the card takes for
    ``work`` (the two compute units run side by side, so the slower of
    them), and which of bytes and operations sets it."""
    t_bytes = work.nbytes / HBM_BW * 1e3
    t_ops = max(work.fp32 / PEAK_FP32_FLOPS,
                work.tf32 / PEAK_TF32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _used(nbr: torch.Tensor, valid: torch.Tensor, N: int):
    """``(idx, used)``: the clamped sources and the included slots."""
    idx = nbr.long()
    return idx, (idx >= 0) & valid[idx.clamp(0, max(N - 1, 0))]


def _kept(nbr: torch.Tensor, valid: torch.Tensor, N: int, index) -> int:
    """The slots a gradient keeps (0 <= nbr < N, valid)."""
    if index is not None:
        return int(index.offsets[-1])
    idx, used = _used(nbr, valid, N)
    return int((used & (idx < N)).sum())


def serve_layer_work(h, nbr, valid, wn, ws, b, relu=True,
                     self_idx=None) -> Work:
    """Kernel A: each h row gathered once (included neighbors and self
    rows), the valid flag of each neighbor slot, nbr, W, b, out; one add
    per gathered element, the mean's division, the epilogue, and the two
    products as three TF32 products each."""
    N, D = h.shape
    M, f = nbr.shape
    K = wn.shape[1]
    idx, used = _used(nbr, valid, N)
    self_rows = (torch.arange(M, device=h.device) if self_idx is None
                 else self_idx.long().clamp(0, N - 1))
    rows = torch.cat([idx.clamp(0, N - 1)[used], self_rows]).unique().numel()
    nbytes = (rows * D * 4 + int((idx >= 0).sum()) + M * f * 4
              + 2 * D * K * 4 + K * 4 + M * K * 4)
    adds = int(used.sum()) * D
    return Work(nbytes, adds + M * D + 2.0 * M * K, 12.0 * M * D * K,
                ffma=4.0 * M * D * K + adds)


def hec_lookup_work(tags, values, vids, out) -> Work:
    """Kernel B: the vids, each probed tag row and each hit value line read
    once, hit/set/way and the rows written; ``ways`` compares a probe.
    ``out`` is the call's ``(hit, set, way, emb)``."""
    hit, sets, way, _ = out
    n = vids.shape[0]
    _, ways, d = values.shape
    lines = (sets.long() * ways + way.long())[hit].unique().numel()
    nbytes = (n * 4 + sets.unique().numel() * ways * 4 + lines * d * 4
              + n * (1 + 4 + 4) + n * d * 4)
    return Work(nbytes, float(n * ways))


def update_fwd_work(agg, self_h, wn, ws, b, **_) -> Work:
    """Kernel C: agg, self, Wn, Ws, b read once, out written; two products
    of 2NCK operations as three TF32 products each, the epilogue's 3NK on
    the CUDA cores."""
    N, C = agg.shape
    K = wn.shape[1]
    nbytes = (2 * N * C + 2 * C * K + K + N * K) * 4
    return Work(nbytes, 3.0 * N * K, 3 * 4.0 * N * C * K,
                ffma=4.0 * N * C * K + 3 * N * K)


def update_bwd_work(g, out, relu=True, **_) -> Work:
    """Kernel D: g (and out, with ReLU) read once, dZ and db written."""
    N, K = g.shape
    return Work((N * K * (3 if relu else 2) + K) * 4.0, 2.0 * N * K)


def agg_fwd_work(h, nbr, valid) -> Work:
    """Kernel E: each included row of h read once, the valid flag of each
    slot, nbr, the mean and count written; one add per included element
    and the division."""
    N, D = h.shape
    M, f = nbr.shape
    idx, used = _used(nbr, valid, N)
    rows = idx.clamp(0, N - 1)[used].unique().numel()
    nbytes = (rows * D * 4 + int((idx >= 0).sum()) + M * f * 4
              + M * D * 4 + M * 4)
    return Work(nbytes, float(int(used.sum()) * D + M * D))


def agg_bwd_work(g, nbr, valid, cnt, num_src, index=None) -> Work:
    """Kernel F: g and cnt read once, the transposed index (offsets, chunk
    bases, the kept slots), dh written whole; a divide and an add per
    kept element."""
    M, D = g.shape
    kept = _kept(nbr, valid, num_src, index)
    nbytes = (M * D * 4 + M * 4 + 2 * (num_src + 1) * 4 + kept * 4
              + num_src * D * 4)
    return Work(nbytes, 2.0 * kept * D)


def gat_fwd_work(z, e_u, e_v, nbr, valid, dst_idx=None, **_) -> Work:
    """Kernel G: each included source's z and e_u row read once, the valid
    flag of each slot, nbr, the e_v (and dst) rows, out written; per
    included slot two flops per z element and about 8 per head (the
    softmax)."""
    N, H, dh = z.shape
    M, f = nbr.shape
    idx, used = _used(nbr, valid, N)
    rows = idx.clamp(0, N - 1)[used].unique().numel()
    slots = int(used.sum())
    nbytes = (rows * (H * dh + H) * 4 + int((idx >= 0).sum())
              + M * f * 4 + M * H * 4 + (M * 4 if dst_idx is not None
                                         else 0) + M * H * dh * 4)
    return Work(nbytes, slots * (2.0 * H * dh + 8 * H))


def gat_bwd_work(g, z, e_u, e_v, nbr, valid, dst_idx=None, index=None,
                 dindex=None, **_) -> Work:
    """Kernel H: g, the included sources' z and e_u rows, the slots' valid
    flags, nbr and e_v read once, the transposed index read once; the
    scratch alpha and ds per included slot and head written once and read
    once per kept slot; dz, de_u and de_v written whole.  Per included
    slot a dot product, per kept slot a scaled add, per z element."""
    N, H, dh = z.shape
    M, f = nbr.shape
    idx, used = _used(nbr, valid, N)
    rows = idx.clamp(0, N - 1)[used].unique().numel()
    inc, kept = int(used.sum()), _kept(nbr, valid, N, index)
    nbytes = (M * H * dh * 4 + rows * (H * dh + H) * 4
              + int((idx >= 0).sum()) + M * f * 4 + M * H * 4
              + 2 * (N + 1) * 4 + kept * 4
              + 2 * inc * H * 4 + 2 * kept * H * 4
              + N * H * dh * 4 + N * H * 4 + e_v.shape[0] * H * 4)
    return Work(nbytes, inc * (2.0 * H * dh + 12 * H) + kept * 2.0 * H * dh)


def sample_draw_work(indptr, indices, wtab, cur, seed, allow=None, *, f,
                     num_solid, width, policy="uniform") -> Work:
    """Kernel I: cur (and allow) and the output per row, two indptr words
    per valid row, each candidate's index once, and under cv the weight
    of each candidate of a row wider than f; one hash (about 12 integer
    operations) per candidate of such a row."""
    n = cur.shape[0]
    ip = indptr.long()
    ok = (cur >= 0) & (cur < num_solid)
    if allow is not None:
        ok &= allow
    vc = torch.where(ok, cur.long(), 0)
    deg = torch.where(ok, ip[vc + 1] - ip[vc], 0)
    cand, cand_big = int(deg.sum()), int(deg[deg > f].sum())
    nbytes = (n * (4 + 4 * f) + (n if allow is not None else 0)
              + int(ok.sum()) * 8 + cand * 4
              + (cand_big * 4 if policy == "cv" else 0))
    return Work(nbytes, 12.0 * cand_big)


def hec_probe_work(tags, values, vids, alive=None) -> Work:
    """Kernel J: each probed tag row and each hit value line read once,
    the vids (and alive) read, the ``[R, B, n, d + 1]`` response written
    once; ``ways`` compares a probe."""
    from repro_torch.kernels.hec_search import hec_lookup_ref
    R, B, n = vids.shape
    ways, d = values.shape[2], values.shape[3]
    rows, lines = 0, 0
    for r in range(R):
        hit, sets, way, _ = hec_lookup_ref(tags[r], values[r],
                                           vids[r].reshape(-1))
        rows += sets.unique().numel()
        lines += (sets.long() * ways + way.long())[hit].unique().numel()
    probes = R * B * n
    nbytes = (probes * 4 + rows * ways * 4 + lines * d * 4
              + probes * (d + 1) * 4 + (R if alive is not None else 0))
    return Work(nbytes, float(probes * ways))


# the StepCost that counts, None when none does
active: Optional["StepCost"] = None


def counted(work: Callable, with_out: bool = False) -> Callable:
    """Decorates a kernel wrapper: while a :class:`StepCost` is active,
    each call (the plain version's on the CPU included) records
    ``work(*args, **kwargs)``, or ``work(*args, out, **kwargs)`` with
    ``with_out``, under the wrapper's name, and the products inside it
    are not counted again; when none is, the call is the wrapper's."""
    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if active is None:
                return fn(*args, **kwargs)
            return active.record(fn, work, with_out, args, kwargs)
        return call
    return wrap


_PRODUCTS = {"mm", "addmm", "bmm", "baddbmm"}


class _Products(TorchDispatchMode):
    """Counts every matrix product outside a kernel wrapper."""

    def __init__(self, cost: "StepCost"):
        super().__init__()
        self.cost = cost

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name in _PRODUCTS and not self.cost._in_kernel:
            a, b = (args[1], args[2]) if name in ("addmm", "baddbmm") \
                else (args[0], args[1])
            k = a.shape[-1]
            flops = 2.0 * out.numel() * k
            nbytes = sum(t.numel() * t.element_size() for t in args
                         if isinstance(t, torch.Tensor)) \
                + out.numel() * out.element_size()
            self.cost.products.append((name, tuple(a.shape),
                                       tuple(b.shape), flops, nbytes))
        return out


class StepCost:
    """Counts what the code run inside it does, for one step of
    ``num_ranks`` stacked ranks::

        with StepCost(R, trainer.comm) as cost:
            trainer.train_step(state, data, mb, seed)
        report = cost.analyze()

    Inside, the kernel wrappers (:func:`counted`) record their calls
    with the work of each, and the collective its calls; :meth:`analyze`
    gives the totals per rank."""

    def __init__(self, num_ranks: int, comm=None):
        self.num_ranks = num_ranks
        self.comm = comm
        self.launches: Dict[str, List[Work]] = defaultdict(list)
        self.products: List[tuple] = []
        self.collectives: List[Tuple[str, int]] = []
        self._in_kernel = 0
        self._stack = contextlib.ExitStack()

    def record(self, fn: Callable, work: Callable, with_out: bool,
               args: tuple, kwargs: dict):
        """One call of the kernel wrapper ``fn`` (:func:`counted`)."""
        self._in_kernel += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self._in_kernel -= 1
        with torch.no_grad():
            w = (work(*args, out, **kwargs) if with_out
                 else work(*args, **kwargs))
        self.launches[fn.__name__].append(w)
        return out

    def __enter__(self) -> "StepCost":
        global active
        if active is not None:
            raise RuntimeError("a StepCost is already counting")
        active = self
        self._stack.callback(self._deactivate)
        if self.comm is not None:
            self.collectives = self._stack.enter_context(self.comm.record())
        self._stack.enter_context(_Products(self))
        return self

    @staticmethod
    def _deactivate():
        global active
        active = None

    def __exit__(self, *exc):
        self._stack.close()
        return False

    def analyze(self) -> dict:
        """Per rank: ``flops``, ``bytes_accessed``, ``collective_bytes``,
        ``collectives {kind: {count, bytes}}`` (the reference's keys);
        ``kernels {name: {launches, bytes, flops}}`` and ``products``; the
        roofline inputs ``fp32_ops``, ``tf32_ops`` and ``bound_s``, the
        sum of every launch's and product's least time, and ``compute_s``
        and ``memory_s``, the sums of their operation and byte terms."""
        R = float(self.num_ranks)
        kernels, flops, nbytes, fp32, tf32 = {}, 0.0, 0.0, 0.0, 0.0
        bound_s = compute_s = 0.0
        for name, works in sorted(self.launches.items()):
            k = {"launches": len(works) / R,
                 "bytes": sum(w.nbytes for w in works) / R,
                 "flops": sum(w.flops for w in works) / R}
            kernels[name] = k
            flops += k["flops"]
            nbytes += k["bytes"]
            fp32 += sum(w.fp32 for w in works) / R
            tf32 += sum(w.tf32 for w in works) / R
            bound_s += sum(bound(w)[0] for w in works) / R / 1e3
            compute_s += sum(max(w.fp32 / PEAK_FP32_FLOPS,
                                 w.tf32 / PEAK_TF32_FLOPS)
                             for w in works) / R
        p_flops = sum(p[3] for p in self.products) / R
        p_bytes = sum(p[4] for p in self.products) / R
        bound_s += sum(bound(Work(p[4], p[3]))[0]
                       for p in self.products) / R / 1e3
        compute_s += p_flops / PEAK_FP32_FLOPS
        coll = defaultdict(lambda: {"count": 0.0, "bytes": 0.0})
        for kind, b in self.collectives:
            coll[kind]["count"] += 1
            coll[kind]["bytes"] += b
        return {
            "flops": flops + p_flops,
            "bytes_accessed": nbytes + p_bytes,
            "collectives": {k: dict(v) for k, v in coll.items()},
            "collective_bytes": float(sum(v["bytes"]
                                          for v in coll.values())),
            "kernels": kernels,
            "products": {"count": len(self.products) / R, "flops": p_flops,
                         "bytes": p_bytes},
            "fp32_ops": fp32 + p_flops, "tf32_ops": tf32,
            "bound_s": bound_s, "compute_s": compute_s,
            "memory_s": (nbytes + p_bytes) / HBM_BW,
        }

