"""Background minibatch preparation: deterministic plan + bounded prefetch
(own copy of ``repro/pipeline/prefetcher.py``).

Determinism contract: every minibatch is a pure function of
``(base_seed, epoch, step)`` — each step owns a private
``np.random.Generator`` seeded from that triple, and the per-epoch shuffle
of each rank's training seeds likewise owns a per-``(epoch, rank)``
stream, with the reference's domain tags.  The host draw is the
vectorized sampler, or with ``PipelineConfig(vectorized=False)`` the
reference's per-row ``sample_blocks``.  With ``SamplerConfig.device_draw``
(and the vectorized sampler) each rank's fanout draw runs through its
:class:`~repro_torch.pipeline.vectorized_sampler.DeviceSampler` on
``device`` (kernel I on the card, its plain version on the CPU), seeded
by the reference's ``fold_in`` chain.  Either way the port draws exactly
the reference's minibatches, for any number of worker threads.

Rank imbalance: an epoch takes ``max_r ceil(train_r / batch)`` steps on
every rank; ranks that run out of seeds contribute empty (fully masked)
seed batches.

With ``pin_memory`` the worker also pins each host batch (in the
``host_prep`` span), so ``pipeline/staging.py`` can copy it to the card
asynchronously.

Worker-crash containment: a failed step is drawn again once, inline (the
same batch, by the per-step streams, pinned as the worker would have
pinned it), and counted as ``prefetch_retries``; a second failure
propagates.  ``SamplingPlan(injector=)`` lets a scheduled
``kill_prefetch`` fault crash the draw of an exact ``(epoch, step)``.
"""
from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import threading
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.gnn import GNNConfig
from repro_torch.device import DeviceLike
from repro_torch.graph.partition import PartitionSet
from repro_torch.graph.sampling import (epoch_minibatches, pad_schedule,
                                        sample_blocks)
from repro_torch.pipeline.vectorized_sampler import (DeviceSampler,
                                                     sample_blocks_vectorized,
                                                     stack_ranks)

# domain-separation tags so shuffle and sampling streams never collide
_SHUFFLE_TAG = 0x5F
_SAMPLE_TAG = 0xA7


def pin_batch(batch: dict) -> dict:
    """A host ``[R, ...]`` batch as page-locked torch tensors (raises
    without a card)."""
    def pin(a):
        return torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
    return {k: [pin(a) for a in v] if isinstance(v, list) else pin(v)
            for k, v in batch.items()}


@dataclasses.dataclass
class SamplingPlan:
    """Deterministic schedule of per-rank seed batches + per-step RNG
    streams.  ``device`` places the device draw's samplers (``None``: the
    card); it is read only when ``cfg.pipeline.sampler.device_draw`` is
    on.  ``pin_memory``: ``sample_host`` returns pinned tensors.
    ``injector`` (a ``resilience.FaultInjector``): ``sample_host`` first
    lets it crash the draw."""
    ps: PartitionSet
    cfg: GNNConfig
    base_seed: int = 0
    device: DeviceLike = None
    pin_memory: bool = False
    injector: Optional[object] = None
    _samplers: Optional[List[DeviceSampler]] = dataclasses.field(
        default=None, init=False, repr=False)
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, init=False, repr=False)

    def epoch_schedule(self, epoch: int) -> List[List[np.ndarray]]:
        """``schedule[step][rank]`` -> seed VID_p array (empty when padded)."""
        bs = self.cfg.batch_size
        per_rank = []
        for r, part in enumerate(self.ps.parts):
            rng = np.random.default_rng(
                [self.base_seed, epoch, r, _SHUFFLE_TAG])
            per_rank.append(epoch_minibatches(part, bs, rng))
        return pad_schedule(per_rank)

    def step_rng(self, epoch: int, step: int) -> np.random.Generator:
        return np.random.default_rng(
            [self.base_seed, epoch, step, _SAMPLE_TAG])

    def device_samplers(self) -> List[DeviceSampler]:
        """One :class:`DeviceSampler` per rank, made at the first call."""
        with self._lock:
            if self._samplers is None:
                s = self.cfg.pipeline.sampler
                self._samplers = [
                    DeviceSampler(p, base_seed=self.base_seed, rank=r,
                                  policy=s.policy, cv_boost=s.cv_boost,
                                  device=self.device)
                    for r, p in enumerate(self.ps.parts)]
            return self._samplers

    def set_cv_residency(self, masks: Sequence[np.ndarray]) -> None:
        """Install each rank's HEC residency (bool over VID_p) for ``cv``
        draws."""
        for sampler, m in zip(self.device_samplers(), masks):
            sampler.set_residency(m)

    def sample_host(self, epoch: int, step: int,
                    seed_lists: Sequence[np.ndarray]) -> dict:
        """One synchronized [R, ...] host minibatch for ``(epoch, step)``."""
        cfg = self.cfg
        if self.injector is not None:
            # raises PrefetchWorkerKilled once per scheduled fault; the
            # retry of the same (epoch, step) then draws the batch
            self.injector.prefetch_crash(epoch, step)
        rng = self.step_rng(epoch, step)
        sampler = (sample_blocks_vectorized if cfg.pipeline.vectorized
                   else sample_blocks)
        # the device draw: per-rank closures over (epoch, step); the seed
        # chain, not `rng`, carries the determinism
        use_dev = (cfg.pipeline.sampler.device_draw
                   and cfg.pipeline.vectorized)
        samplers = self.device_samplers() if use_dev else None
        # the spans run on whichever prefetch worker takes the step
        with obs.span("sample", epoch=epoch, step=step):
            mbs = []
            for r in range(self.ps.num_parts):
                kw = {}
                if use_dev:
                    kw["draw_fn"] = (
                        lambda k, cur, f, allow, _s=samplers[r]:
                        _s.draw(epoch, step, k, cur, f, allow))
                mbs.append(sampler(self.ps.parts[r], seed_lists[r],
                                   cfg.fanouts, rng, cfg.batch_size, **kw))
        with obs.span("host_prep", epoch=epoch, step=step):
            batch = stack_ranks(mbs)
            return pin_batch(batch) if self.pin_memory else batch

    def batches(self, schedule: List[Sequence[np.ndarray]],
                epoch: int) -> Iterator[dict]:
        """Host minibatches of ``schedule`` in step order, prefetched."""
        pcfg = self.cfg.pipeline
        return prefetch(lambda step: self.sample_host(epoch, step,
                                                      schedule[step]),
                        len(schedule), pcfg.num_workers, pcfg.prefetch_depth)


def prefetch(make_fn: Callable[[int], dict], num_steps: int,
             num_workers: int, depth: int) -> Iterator[dict]:
    """Yield ``make_fn(0..num_steps-1)`` in order, up to ``depth`` in flight.

    ``num_workers <= 0`` runs the calls inline.  Results are consumed
    strictly in step order; because each step owns its RNG stream the
    output is the same for any worker count.  A worker's exception
    surfaces here, when its step is consumed: the step is drawn again
    ONCE, inline (the same batch), counted as ``prefetch_retries``; a
    second failure propagates.  The inline path does not retry.
    """
    if num_workers <= 0:
        for step in range(num_steps):
            yield make_fn(step)
        return
    depth = max(depth, 1)
    pool = concurrent.futures.ThreadPoolExecutor(
        max_workers=num_workers, thread_name_prefix="minibatch-prefetch")
    try:
        inflight = collections.deque()
        nxt = 0
        while nxt < num_steps and len(inflight) < depth:
            inflight.append((nxt, pool.submit(make_fn, nxt)))
            nxt += 1
        while inflight:
            step, fut = inflight.popleft()
            try:
                batch = fut.result()
            except Exception:
                obs.count("prefetch_retries")
                batch = make_fn(step)
            if nxt < num_steps:
                inflight.append((nxt, pool.submit(make_fn, nxt)))
                nxt += 1
            yield batch
    finally:
        # the consumer may abandon the generator mid-epoch: drop queued
        # work instead of sampling batches nobody wants
        pool.shutdown(wait=True, cancel_futures=True)
