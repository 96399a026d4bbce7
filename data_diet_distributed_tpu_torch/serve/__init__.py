"""Scoring as a service (counterpart of ``data_diet_distributed_tpu/serve/``):
one long-lived process keeps the dataset and the score functions warm on the
card and answers HTTP requests.

* ``engine.py``: the warm-callable engine (``fit`` / ``score`` /
  ``evaluate``, tenants, checkpoint refresh, the program cache keyed by
  ``(arch, geometry, method)``);
* ``batcher.py``: request coalescing into padded dispatches, admission
  control (429 + Retry-After), weighted round-robin across tenants;
* ``server.py``: the HTTP surface on the obs chassis (``/v1/score``,
  ``/v1/rank``, ``/v1/topk`` streamed, ``/v1/refresh``, plus /healthz
  /metrics /status /flightrec) and the ``cli serve`` entry with the
  SIGTERM drain (exit 75);
* ``router.py``: the health-aware reverse proxy over a replicated pod
  (circuit breaking, failover of idempotent requests with the replay cache,
  optional hedging, the one-at-a-time refresh roll with the canary hold and
  rollback); stdlib only;
* ``fleet.py``: the ``serve.replicas > 1`` / ``serve.max_replicas``
  supervisor: N ``cli serve`` replicas as child processes behind the
  router, respawned under the elastic restart budget, probation for a
  partition, the autoscaler, the refresh and tuning-manifest rolls. It
  touches no CUDA.
"""

from .batcher import Backpressure, Draining, ScoreBatcher  # noqa: F401
from .engine import ServeEngine  # noqa: F401
from .fleet import Autoscaler, ServeFleet, discover_steps  # noqa: F401
from .router import CircuitBreaker, Replica, ServeRouter  # noqa: F401
from .server import ServeServer, ServeService, run_serve  # noqa: F401
