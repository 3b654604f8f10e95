"""Flat-npz checkpoints of the port's training state, in the reference's
archive format (counterpart of ``repro/train/checkpoint.py``).

An archive holds ``leaf_<i>`` for the i-th leaf of the reference trainer's
state tree and ``__step__``.  The leaf order is jax's flattening of
``{"params", "opt_state", "hec", "hot", "inflight", "step"}``: the dict
keys sorted (``hec``, ``hot``, ``inflight``, ``opt_state``, ``params``,
``step``), a state's dataclass fields in order (``HECState(tags, age,
values)``, ``HotTierState(values, age)``), every layer's per-rank states
stacked ``[R, ...]``, the in-flight queues' keys sorted, Adam's ``mu``,
``nu`` and ``step``, then the parameters in the model's
``parameter_list`` order.  So an archive of either package restores into
the other.

Writes are atomic: the leaves stream one by one (one on the host at a
time) into ``<path>.tmp``, an open file (``np.savez`` given a path
string appends ``.npz``), which is then moved into place with
``os.replace``.  ``restore`` reads the
archive's leaf headers first and raises :class:`CheckpointMismatchError`
on a leaf count or a shape that differs, before it writes anything; then
it copies the leaves, one at a time, into the live state on its device.
"""
from __future__ import annotations

import os
import zipfile
from typing import Callable, Iterable, List, Tuple

import numpy as np
import torch


class CheckpointMismatchError(ValueError):
    """The archive does not match the state (leaf count or a shape)."""


def save_leaves(path: str, leaves: Iterable, step: int = 0) -> str:
    """Write ``leaf_<i>`` (tensors or arrays, in order) and ``__step__``
    to exactly ``path``, atomically; returns ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f, zipfile.ZipFile(
            f, mode="w", compression=zipfile.ZIP_STORED,
            allowZip64=True) as z:
        def write(name, x):
            if isinstance(x, torch.Tensor):
                x = x.detach().cpu().numpy()
            with z.open(name + ".npy", "w", force_zip64=True) as out:
                np.lib.format.write_array(out, np.asarray(x),
                                          allow_pickle=False)
        for i, x in enumerate(leaves):   # one leaf on the host at a time
            write(f"leaf_{i}", x)
        write("__step__", np.asarray(step))
    os.replace(tmp, path)
    return path


def _leaves(state: dict) -> List[Tuple[Callable, tuple, Callable]]:
    """The state's leaves in the reference's order, each as (a function
    that reads it, its shape, a function that copies an array of that
    shape into the live state): the archive's layout, in one place."""
    def one(t):
        def put(a):
            t.copy_(torch.as_tensor(np.ascontiguousarray(a)))
        return (lambda: t), tuple(t.shape), put

    def ranks(ts):                              # [R, ...] over the ranks
        def get():
            return np.stack([t.detach().cpu().numpy() for t in ts])

        def put(a):
            for r, t in enumerate(ts):
                t.copy_(torch.as_tensor(np.ascontiguousarray(a[r])))
        return get, (len(ts),) + tuple(ts[0].shape), put

    def scalar(get, set_):
        return (lambda: np.asarray(get(), np.int32)), (), \
            (lambda a: set_(int(a)))

    opt, queues = state["opt"], state["inflight"]
    out = [ranks([getattr(st, f) for st in layer])
           for layer in state["hec"] for f in ("tags", "age", "values")]
    out += [one(t) for tier in state["hot"] for t in (tier.values, tier.age)]
    out += [ranks([q[k] for q in queues]) for k in sorted(queues[0])]
    out += [one(t) for t in list(opt.mu) + list(opt.nu)]
    out.append(scalar(lambda: opt.step,
                      lambda v: setattr(opt, "step", v)))
    out += [one(p.data) for p in state["model"].parameter_list()]
    out.append(scalar(lambda: state["step"],
                      lambda v: state.__setitem__("step", v)))
    return out


def state_leaves(state: dict) -> List:
    """The state's leaves in the reference's order (host arrays for the
    rank-stacked ones and the counts, the live tensors for the rest)."""
    return [get() for get, _, _ in _leaves(state)]


def save(path: str, state: dict, step: int = 0) -> str:
    """The whole training state (``DistTrainer.init_state``'s dict) as a
    reference archive; the caller has joined the push
    (``DistTrainer.join_push``)."""
    return save_leaves(path, (get() for get, _, _ in _leaves(state)), step)


def _leaf_shapes(path: str) -> dict:
    shapes = {}
    with zipfile.ZipFile(path) as z:
        for name in z.namelist():
            with z.open(name) as f:
                major, _ = np.lib.format.read_magic(f)
                read = (np.lib.format.read_array_header_1_0 if major == 1
                        else np.lib.format.read_array_header_2_0)
                shapes[name[:-len(".npy")]] = read(f)[0]
    return shapes


@torch.no_grad()
def restore(path: str, state: dict) -> Tuple[dict, int]:
    """Load the archive at ``path`` into ``state`` in place (on the
    state's device); returns ``(state, step)`` with the archive's
    ``__step__``.  Raises :class:`CheckpointMismatchError`, touching
    nothing, when the leaf count or a leaf's shape differs."""
    leaves = _leaves(state)
    shapes = _leaf_shapes(path)
    n = sum(1 for k in shapes if k.startswith("leaf_"))
    if n != len(leaves):
        raise CheckpointMismatchError(
            f"{path}: checkpoint has {n} leaves, target state has "
            f"{len(leaves)}")
    for i, (_, shape, _) in enumerate(leaves):
        if tuple(shapes[f"leaf_{i}"]) != shape:
            raise CheckpointMismatchError(
                f"leaf {i}: ckpt {tuple(shapes[f'leaf_{i}'])} != model "
                f"{shape}")
    with np.load(path) as data:
        for i, (_, _, put) in enumerate(leaves):
            put(data[f"leaf_{i}"])
        step = int(data["__step__"])
    return state, step
