"""ObsSession: install the instruments of a command (counterpart of
``data_diet_distributed_tpu/obs/session.py``), reduced to what the port has:
the metrics registry, the per-rank heartbeat (``obs.heartbeat*``) and the SLO
engine (``obs.slo_*``). Every slot is cleared on exit, so a later session (the
tests run many in one process) starts clean. The tracer, the flight recorder,
the XLA introspector, the scoreboard, the fleet view and ``obs.server_port``'s
status server are not ported.
"""

from __future__ import annotations

from ..parallel.mesh import process_index
from . import heartbeat, registry, slo


class ObsSession:
    def __init__(self, cfg, logger=None):
        self.cfg = cfg
        self.logger = logger
        self.registry: registry.MetricsRegistry | None = None
        self.heartbeat: heartbeat.Heartbeat | None = None
        self.slo: slo.SloEngine | None = None

    def __enter__(self) -> "ObsSession":
        self.registry = registry.install(registry.MetricsRegistry())
        hb_dir = heartbeat.dir_from_cfg(self.cfg)
        if hb_dir is not None:
            self.heartbeat = heartbeat.install(heartbeat.Heartbeat(
                hb_dir, process_index(),
                min_interval_s=self.cfg.obs.heartbeat_interval_s))
        engine = slo.SloEngine.from_cfg(self.cfg, logger=self.logger)
        if engine is not None:
            self.slo = slo.install(engine)
        return self

    def __exit__(self, exc_type, exc, tb):
        slo.uninstall()
        heartbeat.uninstall()
        registry.uninstall()
        return False
