"""Observability (counterpart of ``data_diet_distributed_tpu/obs/``): the run's
lineage, ``metrics.MetricsLogger`` and ``run_summary``, the metrics registry,
the tracer, the flight recorder, program introspection and MFU
(``introspect.py``, the JAX package's ``xla.py``), the memory watermark, the
``torch.profiler`` window, the resource monitor, score telemetry,
communication telemetry, the SLO engine, per-rank heartbeats and the fleet
view, request tracing and the status server; after a run, the
cross-attempt timeline (``timeline.py``) and the post-mortem
(``postmortem.py``, ``python -m data_diet_distributed_tpu_torch.obs.postmortem``)
and the post-run plots (``plots.py``, exported here as in the JAX package).
Every instrument sits in a module-level slot and is a no-op until installed
(``session.ObsSession`` installs them for a command). The modules import
torch only inside the functions that need it."""

from .plots import plot_metrics, plot_score_stats, plot_scores, plot_utilization

__all__ = ["plot_metrics", "plot_score_stats", "plot_scores", "plot_utilization"]
