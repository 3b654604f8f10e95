"""Double-buffered host-to-device staging and the ``MinibatchPipeline``
iterator (own copy of ``repro/pipeline/staging.py``).

The minibatch path of training::

    CSR sampler --> prefetch thread pool (per-step RNG streams, bounded
    depth; the worker pins each batch) --> copies on a CUDA copy stream,
    one batch ahead --> the step on the consumer's stream

Where the reference relies on jax's asynchronous ``device_put``, the card
path here issues the ``non_blocking`` copies of batch k+1 on its own copy
stream before it yields batch k, and records one CUDA event per batch.
Before batch k is yielded the host waits for its event (its copy was
issued a step earlier, so with double buffering it has long completed)
and the consumer's stream waits on it too; the batch's tensors are
recorded on the consumer's stream, so the caching allocator cannot hand
their blocks to a later copy while the step still reads them.  The
pinned host tensors stay referenced until their copy's event has
completed, so neither a worker nor the consumer can reuse a buffer the
copy still reads.  With ``double_buffer=False`` each batch is put and
waited for in step order.  On the CPU the copies are plain
``.to(device)``.  Every path yields the same batches in the same order.
"""
from __future__ import annotations

import collections
from typing import Iterator, List, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.gnn import GNNConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graph.partition import PartitionSet
from repro_torch.pipeline.prefetcher import SamplingPlan

EVAL_EPOCH_TAG = 1 << 20   # eval streams live far away from training epochs


def _map(mb: dict, fn) -> dict:
    return {k: [fn(a) for a in v] if isinstance(v, list) else fn(v)
            for k, v in mb.items()}


def _tensors(mb: dict) -> List[torch.Tensor]:
    return [a for v in mb.values()
            for a in (v if isinstance(v, list) else [v])]


def minibatch_to_device(mb: dict, device) -> dict:
    """The host ``[R, ...]`` minibatch (``stack_ranks``) as tensors on
    ``device``, copied in step order."""
    return _map(mb, lambda a: torch.as_tensor(a).to(device))


def device_stage(host_batches: Iterator[dict], double_buffer: bool = True,
                 device: DeviceLike = None) -> Iterator[dict]:
    """Map host minibatches to ``device``, keeping one copy in flight
    (``double_buffer``).  On the card the host batches must be pinned
    (``SamplingPlan(pin_memory=True)``); the ``stage`` span times the
    copies' issue."""
    device = resolve_device(device)
    if device.type != "cuda":
        def put(host):
            with obs.span("stage"):
                return minibatch_to_device(host, device)
        ready = lambda mb: mb  # noqa: E731
        pending = None
    else:
        copy = torch.cuda.Stream(device)
        pending = collections.deque()      # (event, pinned host batch)

        def put(host):
            with obs.span("stage"):
                for a in _tensors(host):
                    if not (isinstance(a, torch.Tensor) and a.is_pinned()):
                        raise ValueError(
                            "device_stage: a host batch on the card path "
                            "must be pinned (SamplingPlan(pin_memory="
                            "True))")
                with torch.cuda.stream(copy):
                    mb = _map(host, lambda a: a.to(device,
                                                   non_blocking=True))
                    done = torch.cuda.Event()
                    done.record(copy)
                while pending and pending[0][0].query():
                    pending.popleft()
                pending.append((done, host))
                return mb, done

        def ready(staged):
            mb, done = staged
            done.synchronize()
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(done)
            for a in _tensors(mb):
                a.record_stream(consumer)
            return mb
    try:
        if not double_buffer:
            for host in host_batches:
                yield ready(put(host))
            return
        staged = None
        for host in host_batches:
            nxt = put(host)
            if staged is not None:
                yield ready(staged)
            staged = nxt
        if staged is not None:
            yield ready(staged)
    finally:
        # the consumer may drop the generator with copies in flight: let
        # them finish before their pinned sources go
        for done, _ in pending or ():
            done.synchronize()


def eval_schedule(plan: SamplingPlan, num_batches: int,
                  seed: int) -> List[List[np.ndarray]]:
    """Test-set seed batches, one RNG stream per rank (the reference's
    ``MinibatchPipeline.eval_batches``); they are sampled at epoch
    ``EVAL_EPOCH_TAG + seed``."""
    bs = plan.cfg.batch_size
    per_rank = []
    for r, part in enumerate(plan.ps.parts):
        rng = np.random.default_rng([plan.base_seed, seed, r])
        per_rank.append((np.flatnonzero(part.test_mask), rng))
    return [[test[rng.permutation(len(test))[:bs]]
             for test, rng in per_rank] for _ in range(num_batches)]


class MinibatchPipeline:
    """Asynchronous minibatch source for ``DistTrainer``: the sampling
    plan (deterministic RNG streams), the prefetch pool and the staging;
    ``epoch_batches(ep)`` yields device minibatches in step order.
    ``injector`` (a ``resilience.FaultInjector``) goes to the plan."""

    def __init__(self, ps: PartitionSet, cfg: GNNConfig, base_seed: int = 0,
                 device: DeviceLike = None, injector=None):
        self.cfg = cfg
        self.pcfg = cfg.pipeline
        self.device = resolve_device(device)
        self.plan = SamplingPlan(ps=ps, cfg=cfg, base_seed=base_seed,
                                 device=self.device,
                                 pin_memory=self.device.type == "cuda",
                                 injector=injector)

    @property
    def num_ranks(self) -> int:
        return self.plan.ps.num_parts

    def set_cv_residency(self, masks: Sequence[np.ndarray]) -> None:
        """Each rank's HEC residency for the ``cv`` draw (see
        ``SamplingPlan.set_cv_residency``)."""
        self.plan.set_cv_residency(masks)

    def batches(self, schedule: List[Sequence[np.ndarray]],
                epoch: int) -> Iterator[dict]:
        """Pipeline an explicit ``schedule[step][rank]`` seed schedule."""
        return device_stage(self.plan.batches(schedule, epoch),
                            self.pcfg.double_buffer, device=self.device)

    def epoch_batches(self, epoch: int) -> Iterator[dict]:
        """Device minibatches for one training epoch (shuffled, padded)."""
        return self.batches(self.plan.epoch_schedule(epoch), epoch)

    def eval_batches(self, num_batches: int, seed: int = 123
                     ) -> Iterator[dict]:
        """Deterministic test-set minibatches (one RNG stream per rank)."""
        return self.batches(eval_schedule(self.plan, num_batches, seed),
                            epoch=EVAL_EPOCH_TAG + seed)
