"""Observability of the serving slice (counterpart of
``data_diet_distributed_tpu/obs/``): ``metrics.MetricsLogger``, the metrics
registry, request tracing, per-rank heartbeats, the serve SLOs and the
status-server chassis. Every instrument sits in a module-level slot and is a
no-op until installed (``session.ObsSession`` installs them for a command).
``registry``, ``reqtrace``, ``heartbeat``, ``slo`` and ``server`` import no
torch."""
