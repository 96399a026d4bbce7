"""ObsSession: build and install a command's instruments (counterpart of
``data_diet_distributed_tpu/obs/session.py``).

From ``cfg.obs``: the run's lineage, the tracer (``obs.trace``:
``obs.trace_path``, else ``trace.json`` next to the metrics stream, per rank
and attempt), the metrics registry (``obs.prom_path`` on rank 0), the
per-rank heartbeat, the flight recorder (``obs.flightrec``), the program
introspector and the device-memory monitor (``obs.xla_introspect``,
``obs.hbm_jump_frac``), the scoreboard (``obs.score_telemetry``), the SLO
engine (``obs.slo_*``), the fleet monitor (``obs.fleet``, its watch thread
across ranks) and ``obs.server_port``'s status server. Each goes into its
module-level slot, where library code reaches it. On exit: an exception other
than ``Preempted`` dumps the flight recorder (``exception:<Type>``), the
registry's final state lands in ``obs.prom_path``, the server stops, the
trace is terminated, and every slot is cleared, so a later session (the tests
run many in one process) starts clean. Entered after the process group is
joined (the file names carry the rank).
"""

from __future__ import annotations

import os

from ..parallel.mesh import process_index, world_size
from . import (fleet, flightrec, heartbeat, introspect, lineage, registry, scoreboard,
               server, slo, tracing)
from .profiler import ProfileWindow

DEFAULT_TRACE_NAME = "trace.json"


def workdir(cfg) -> str:
    """The directory of the metrics stream, where the trace and the flight
    recorder's dumps go by default (``.`` when ``obs.metrics_path`` is null)."""
    return os.path.dirname(cfg.obs.metrics_path or "") or "."


class ObsSession:
    def __init__(self, cfg, logger=None, device=None):
        self.cfg = cfg
        # The MetricsLogger the instruments emit their records through.
        self.logger = logger
        # The command's device: the introspector's and memory monitor's.
        self.device = device
        self.tracer: tracing.Tracer | None = None
        self.registry: registry.MetricsRegistry | None = None
        self.heartbeat: heartbeat.Heartbeat | None = None
        self.recorder: flightrec.FlightRecorder | None = None
        self.introspector: introspect.Introspector | None = None
        self.scoreboard: scoreboard.Scoreboard | None = None
        self.slo: slo.SloEngine | None = None
        self.fleet: fleet.FleetMonitor | None = None
        self.server: server.StatusServer | None = None

    def __enter__(self) -> "ObsSession":
        import torch
        cfg, o = self.cfg, self.cfg.obs
        rank = process_index()
        lin = lineage.ensure()
        if o.trace:
            base = o.trace_path or os.path.join(workdir(cfg), DEFAULT_TRACE_NAME)
            self.tracer = tracing.install(tracing.Tracer(
                tracing.trace_path_for(base, rank, lin.attempt), rank=rank))
        self.registry = registry.install(registry.MetricsRegistry(
            prom_path=o.prom_path if rank == 0 else None))
        hb_dir = heartbeat.dir_from_cfg(cfg)
        if hb_dir is not None:
            self.heartbeat = heartbeat.install(heartbeat.Heartbeat(
                hb_dir, rank, min_interval_s=o.heartbeat_interval_s))
        if o.flightrec:
            self.recorder = flightrec.install(flightrec.FlightRecorder(
                o.flightrec_dir or workdir(cfg), rank, capacity=o.flightrec_capacity,
                attempt=lin.attempt))
        if o.xla_introspect:
            self.introspector = introspect.install(
                introspect.Introspector(logger=self.logger, device=self.device),
                introspect.HbmMonitor(logger=self.logger, jump_frac=o.hbm_jump_frac,
                                      device=self.device))
        if o.score_telemetry:
            self.scoreboard = scoreboard.install(scoreboard.Scoreboard(
                logger=self.logger, bins=o.score_hist_bins))
        backend = torch.device(self.device).type if self.device is not None else None
        engine = slo.SloEngine.from_cfg(cfg, logger=self.logger, backend=backend)
        if engine is not None:
            self.slo = slo.install(engine)
        if hb_dir is not None and o.fleet:
            self.fleet = fleet.install(fleet.FleetMonitor(
                hb_dir, stale_budget_s=o.slo_heartbeat_stale_s or fleet.DEFAULT_STALE_BUDGET_S,
                logger=self.logger))
            if world_size() > 1:
                self.fleet.start_watch()
        if o.server_port is not None:
            self.server = server.install(server.StatusServer(
                port=o.server_port, host=o.server_host,
                stale_after_s=o.slo_heartbeat_stale_s, logger=self.logger))
            self.server.start()   # a bind failure warns and disables
        ProfileWindow.reset()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc is not None and self.recorder is not None:
            from ..resilience.preemption import Preempted
            if not isinstance(exc, Preempted):   # a preemption dumped its own
                flightrec.record("fault", fault="exception", error=repr(exc)[:300])
                flightrec.dump(f"exception:{type(exc).__name__}")
        if self.registry is not None and self.registry.prom_path:
            try:
                self.registry.write_prometheus(self.registry.prom_path)
            except OSError:
                pass   # a dying disk must not mask the run's own outcome
        ProfileWindow.reset()   # a window a fault left open stops here
        if self.server is not None:
            self.server.stop()
        server.uninstall()
        fleet.uninstall()   # stops the watch thread
        slo.uninstall()
        scoreboard.uninstall()
        introspect.uninstall()
        flightrec.uninstall()
        heartbeat.uninstall()
        registry.uninstall()
        tracing.uninstall()   # terminates the trace file
        return False
