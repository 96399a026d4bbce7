"""Resilience core of the PyTorch port (counterpart of
``data_diet_distributed_tpu/resilience/``):

==================  =========================================================
preemption.py       SIGTERM/SIGINT -> final synchronous checkpoint ->
                    ``Preempted`` / exit 75 (resume with train.resume=true)
sentinel.py         NaN/inf epoch loss detected BEFORE the state is
                    checkpointed; recovery rolls back with a reduced LR
watchdog.py         heartbeat deadline over training steps (a host-side hang
                    -> retriable ``WatchdogTimeout``) and a subprocess-bounded
                    CUDA-init probe with retry and backoff
integrity.py        the checkpoint manifest, verified at restore; corruption
                    falls back to the newest earlier step
stages.py           durable stage manifest and per-seed score partials: the
                    run/sweep/score pipeline re-enters at the exact stage
consensus.py        across ranks: agreed preemption and divergence, the
                    min-agreed restore, the poison side channel
inject.py           deterministic fault injection for all of the above
==================  =========================================================

Configured by the ``resilience:`` config block and ``train.auto_resume_retries``;
events go through the entry points' ``log(kind, **fields)`` as ``fault``,
``recovery``, ``preempted``, ``stage``, ``score_seeds_resumed``,
``consensus`` and ``recovery_refused`` records with the JAX package's field
names. Not here yet: elastic supervision, the checkpoint tiers and the host
kill, rejoin and serve fault classes (ROADMAP.md).
"""

from . import inject  # noqa: F401
from .preemption import EXIT_PREEMPTED, Preempted, PreemptionHandler  # noqa: F401
from .sentinel import DivergenceError, LossSentinel  # noqa: F401
from .watchdog import Watchdog, WatchdogTimeout, probe_devices  # noqa: F401
