"""The resilience plane (own copy of ``repro/resilience``): deterministic
fault injection, stateful crash-resume and degraded-mode serving failover.

* :mod:`~repro_torch.resilience.inject` — a seeded, config-scheduled
  injector that lands payload corruption and drops, NaN poisoning, rank
  delays and prefetch-worker kills at exact ``(epoch, step, rank)``, so
  every chaos run replays bit for bit.
* :mod:`~repro_torch.resilience.checkpoint` — atomic epoch-boundary
  checkpoints of the full training state (params, Adam, HEC, hot tier,
  in-flight push queue); kill, restore, continue gives the
  uninterrupted run's bits.
* :mod:`~repro_torch.resilience.failover` — the per-rank circuit breaker
  behind ``DistServeConfig(failover=True)``.

:class:`ResiliencePlane` (``DistTrainer(resilience=...)``) coordinates
the trainer's side: the fault codes of a step, the NaN/Inf step guard's
``resilience_skipped_steps``, the epoch checkpoints and the
``FLIGHT_resilience.json`` dump.
"""
from repro_torch.resilience.checkpoint import CheckpointManager  # noqa: F401
from repro_torch.resilience.failover import (RankHealthMask,  # noqa: F401
                                             probe_with_timeout)
from repro_torch.resilience.inject import (CODE_CORRUPT_PUSH,  # noqa: F401
                                           CODE_DROP_PUSH, CODE_NAN_STEP,
                                           FaultInjector, FaultSchedule,
                                           FaultSpec, PrefetchWorkerKilled)
from repro_torch.resilience.plane import (ResilienceConfig,  # noqa: F401
                                          ResiliencePlane)
