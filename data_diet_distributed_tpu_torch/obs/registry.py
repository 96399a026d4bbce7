"""Metrics registry: counters, gauges and streaming histograms (counterpart of
``data_diet_distributed_tpu/obs/registry.py``).

One process-wide place every layer reports its numbers to (epoch, eval,
step-dispatch, scoring, checkpoint and per-stage walls, throughput, request
latency, the introspection and SLO gauges), read live by ``/metrics``
(Prometheus text) and ``/status``, snapshotted into the stream as
``{"kind": "metrics"}`` records and, with ``obs.prom_path``, into a
Prometheus textfile.

Histograms keep exact count/sum/max and reservoir-sampled quantiles: the
first ``reservoir`` samples, then uniform replacement (Vitter's algorithm R),
so a long-lived service costs a fixed few KB per histogram.

The module-level helpers (``inc``/``set_gauge``/``observe``/``timed``) are
no-ops until a registry is installed: library code calls them
unconditionally, and an uninstrumented caller pays one ``is None`` check.
"""

from __future__ import annotations

import contextlib
import os
import random
import re
import threading
import time

__all__ = ["MetricsRegistry", "Counter", "Gauge", "Histogram", "percentile",
           "install", "uninstall", "current", "inc", "set_gauge", "observe", "timed",
           "maybe_snapshot"]


def percentile(values: list[float], q: float) -> float:
    """Nearest-rank percentile over an UNSORTED sample (NaN when empty); the
    JAX package's ``obs/profiler.py::percentile``."""
    if not values:
        return float("nan")
    s = sorted(values)
    idx = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
    return s[idx]


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Streaming summary: exact count/sum/max, reservoir-sampled quantiles."""

    def __init__(self, reservoir: int = 2048, seed: int = 0):
        self.count = 0
        self.total = 0.0
        self.max = float("-inf")
        self._cap = reservoir
        self._sample: list[float] = []
        # Private PRNG: reservoir replacement must not perturb (or be
        # perturbed by) anyone else's use of the global random state.
        self._rng = random.Random(seed)

    def record(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v > self.max:
            self.max = v
        if len(self._sample) < self._cap:
            self._sample.append(v)
        else:
            j = self._rng.randrange(self.count)
            if j < self._cap:
                self._sample[j] = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else float("nan")

    def quantile(self, q: float) -> float:
        return percentile(self._sample, q)

    def summary(self, digits: int = 6) -> dict:
        def _r(v: float):
            return round(v, digits) if v == v and v not in (
                float("inf"), float("-inf")) else None

        return {"count": self.count, "mean": _r(self.mean),
                "p50": _r(self.quantile(0.50)), "p95": _r(self.quantile(0.95)),
                "max": _r(self.max if self.count else float("nan")),
                "sum": _r(self.total)}


def _prom_name(prefix: str, name: str) -> str:
    return re.sub(r"[^a-zA-Z0-9_]", "_", f"{prefix}_{name}")


class MetricsRegistry:
    """Create-or-get named instruments; snapshot and export the lot."""

    def __init__(self, prefix: str = "ddt", prom_path: str | None = None):
        self.prefix = prefix
        # Where snapshots also land as a Prometheus textfile (None = off);
        # rank 0 only (ObsSession), so ranks never overwrite each other.
        self.prom_path = prom_path
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self._last_snapshot = 0.0

    def counter(self, name: str) -> Counter:
        with self._lock:
            return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            return self._histograms.setdefault(name, Histogram())

    def peek_histogram(self, name: str) -> Histogram | None:
        """The named histogram if it exists; never creates one."""
        with self._lock:
            return self._histograms.get(name)

    @contextlib.contextmanager
    def timed(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.histogram(name).record(time.perf_counter() - t0)

    def snapshot(self) -> dict:
        """``{"counters": {...}, "gauges": {...}, "histograms": {name:
        summary}}``: the shape of the ``metrics`` record and /status reads."""
        with self._lock:
            return {
                "counters": {k: c.value for k, c in self._counters.items()},
                "gauges": {k: round(g.value, 6) for k, g in self._gauges.items()},
                "histograms": {k: h.summary() for k, h in self._histograms.items()},
            }

    def stage_seconds(self) -> dict[str, float]:
        """Per-stage wall seconds from the ``stage_s:<stage>`` histograms,
        keyed by the stage manifest's names (``score``, ``retrain:<tag>``,
        ``dense:final``): the ``run_summary`` breakdown."""
        with self._lock:
            return {k.split(":", 1)[1]: round(h.total, 3)
                    for k, h in self._histograms.items() if k.startswith("stage_s:")}

    def to_prometheus(self) -> str:
        """node-exporter textfile format; histogram quantiles use the
        summary-type convention (``name{quantile="0.5"}``)."""
        lines: list[str] = []
        snap = self.snapshot()
        for k, v in snap["counters"].items():
            n = _prom_name(self.prefix, k)
            lines += [f"# TYPE {n} counter", f"{n} {v}"]
        for k, v in snap["gauges"].items():
            n = _prom_name(self.prefix, k)
            lines += [f"# TYPE {n} gauge", f"{n} {v}"]
        for k, s in snap["histograms"].items():
            n = _prom_name(self.prefix, k)
            lines.append(f"# TYPE {n} summary")
            for q, key in (("0.5", "p50"), ("0.95", "p95")):
                if s[key] is not None:
                    lines.append(f'{n}{{quantile="{q}"}} {s[key]}')
            lines += [f"{n}_sum {s['sum'] or 0}", f"{n}_count {s['count']}"]
            if s["max"] is not None:
                lines += [f"# TYPE {n}_max gauge", f"{n}_max {s['max']}"]
        return "\n".join(lines) + "\n"

    def write_prometheus(self, path: str) -> None:
        """Atomic (temp + rename): a scraper never reads a half-written file."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp"
        with open(tmp, "w") as fh:
            fh.write(self.to_prometheus())
        os.replace(tmp, path)

    def snapshot_event(self, logger) -> None:
        """One ``{"kind": "metrics"}`` record and a ``prom_path`` refresh."""
        self._last_snapshot = time.monotonic()
        logger.log("metrics", **self.snapshot())
        if self.prom_path:
            self.write_prometheus(self.prom_path)

    def maybe_snapshot(self, logger, every_s: float) -> bool:
        """A snapshot when ``every_s`` (> 0) has passed since the last one;
        called from the epoch boundary."""
        if every_s <= 0 or time.monotonic() - self._last_snapshot < every_s:
            return False
        self.snapshot_event(logger)
        return True


# --------------------------------------------------------- module-level slot

_REGISTRY: MetricsRegistry | None = None


def install(registry: MetricsRegistry) -> MetricsRegistry:
    global _REGISTRY
    _REGISTRY = registry
    return registry


def uninstall() -> None:
    global _REGISTRY
    _REGISTRY = None


def current() -> MetricsRegistry | None:
    return _REGISTRY


def inc(name: str, n: int = 1) -> None:
    if _REGISTRY is not None:
        _REGISTRY.counter(name).inc(n)


def set_gauge(name: str, v: float) -> None:
    if _REGISTRY is not None:
        _REGISTRY.gauge(name).set(v)


def observe(name: str, v: float) -> None:
    if _REGISTRY is not None:
        _REGISTRY.histogram(name).record(v)


def timed(name: str):
    """Histogram-timed context (a null context when nothing is installed)."""
    if _REGISTRY is None:
        return contextlib.nullcontext()
    return _REGISTRY.timed(name)


def maybe_snapshot(logger, every_s: float) -> None:
    if _REGISTRY is not None and logger is not None:
        _REGISTRY.maybe_snapshot(logger, every_s)
