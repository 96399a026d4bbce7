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
  SIGTERM drain (exit 75).

The router and the fleet (``serve.replicas > 1``) are not ported.
"""

from .batcher import Backpressure, Draining, ScoreBatcher  # noqa: F401
from .engine import ServeEngine  # noqa: F401
from .server import ServeServer, ServeService, run_serve  # noqa: F401
