"""Resource-utilization monitor (counterpart of
``data_diet_distributed_tpu/obs/monitor.py``): host CPU, device memory and
the device's duty cycle, sampled by a daemon thread into ``obs.monitor_path``
as JSON lines ``{"ts", "cpu_pct", "devices": [...], "duty_cycle",
"probe_ms", "probe_base_ms"}`` (the JAX package's fields).

* Host CPU from ``/proc/stat`` between samples.
* Device memory from ``torch.cuda.memory_stats`` (allocated bytes, current
  and peak) and the device's total memory (``bytes_limit``); a CPU run has
  no device entry values (nulls).
* Duty cycle by the JAX package's latency probe: a marker enqueued on the
  device's default stream from the monitor thread is reached at once on an
  idle device and after the queued work on a busy one, so "probe latency
  above ``BUSY_FACTOR`` × the idle baseline" means "busy when the probe
  landed"; four probes per interval give a busy fraction. The latency is
  timed on the device (CUDA events against a marker on an idle side
  stream), not by the host, whose clock would count the waits for the GIL
  the command's thread holds (a host-timed probe read every sample busy on
  the card). (NVML is not assumed on the card's machine,
  so ``torch.cuda.utilization`` is not used.) The baseline is taken when the
  monitor starts, before the command's device work, and is a running
  minimum after. On the CPU no duty is reported: there is no device to
  probe.
"""

from __future__ import annotations

import json
import os
import threading
import time

__all__ = ["ResourceMonitor", "sample_devices"]


def _cpu_times() -> tuple[float, float]:
    with open("/proc/stat") as fh:
        parts = fh.readline().split()[1:]
    vals = [float(p) for p in parts]
    idle = vals[3] + (vals[4] if len(vals) > 4 else 0.0)
    return sum(vals), idle


class _DutyProbe:
    """Busy fraction of one CUDA device from default-stream latency probes.

    A probe records two timing events: one on the device's default stream,
    which the device reaches only after the work queued there, then one on an
    idle side stream (PyTorch's pool streams do not wait for the default
    stream), which it reaches at once. Their device-clock gap is the probe's
    latency, so the host's clock is out of the measurement. The command's
    thread may take the GIL between the two records; that delays the second,
    which can hide queued work but never invent it."""

    BUSY_FACTOR = 3.0
    #: Floor of the idle baseline (ms): the two events' own jitter.
    MIN_BASE_MS = 0.01

    def __init__(self, device):
        import torch
        self.device = torch.device(device)
        self._side = torch.cuda.Stream(self.device)
        self._base_ms: float | None = None
        for _ in range(3):   # settle the idle baseline
            self.probe_ms()

    def probe_ms(self) -> float:
        import torch
        side = torch.cuda.Event(enable_timing=True)
        queued = torch.cuda.Event(enable_timing=True)
        queued.record(torch.cuda.default_stream(self.device))
        side.record(self._side)
        queued.synchronize()
        side.synchronize()
        ms = max(0.0, side.elapsed_time(queued))
        base = max(ms, self.MIN_BASE_MS)
        if self._base_ms is None or base < self._base_ms:
            self._base_ms = base
        return ms

    def stats(self, lats: list[float]) -> dict:
        busy = sum(1 for m in lats if m > self.BUSY_FACTOR * self._base_ms)
        return {"duty_cycle": busy / len(lats),
                "probe_ms": round(sum(lats) / len(lats), 3),
                "probe_base_ms": round(self._base_ms, 3)}

    def sample(self, window_s: float, n: int = 4) -> dict:
        lats = []
        for _ in range(n):
            t_round = time.perf_counter()
            lats.append(self.probe_ms())
            time.sleep(max(0.0, window_s / n - (time.perf_counter() - t_round)))
        return self.stats(lats)


def sample_devices(device=None) -> list[dict]:
    """One entry per device the command runs on: allocated bytes (current,
    peak) and the device's total memory; nulls for a CPU run."""
    import torch
    dev = torch.device(device) if device is not None else torch.device("cpu")
    if dev.type != "cuda":
        return [{"device": str(dev), "bytes_in_use": None, "bytes_limit": None,
                 "peak_bytes_in_use": None}]
    stats = torch.cuda.memory_stats(dev)
    return [{"device": str(dev),
             "bytes_in_use": stats.get("allocated_bytes.all.current"),
             "bytes_limit": torch.cuda.get_device_properties(dev).total_memory,
             "peak_bytes_in_use": stats.get("allocated_bytes.all.peak")}]


class ResourceMonitor:
    def __init__(self, path: str, interval_s: float = 1.0, probe_duty: bool = True,
                 device=None):
        self.path = path
        self.interval_s = interval_s
        self.probe_duty = probe_duty
        self.device = device
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._probe: _DutyProbe | None = None

    def start(self) -> "ResourceMonitor":
        # The probe's warm-up runs here, before the caller queues device work,
        # so its baseline is an idle device's.
        import torch
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        if (self.probe_duty and self.device is not None
                and torch.device(self.device).type == "cuda"):
            self._probe = _DutyProbe(self.device)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="obs-resource-monitor")
        self._thread.start()
        return self

    def _run(self) -> None:
        prev_total, prev_idle = _cpu_times()
        probe = self._probe
        with open(self.path, "a", buffering=1) as fh:
            while not self._stop.is_set():
                duty = None
                if probe is not None:
                    try:
                        duty = probe.sample(self.interval_s)
                    except Exception:   # noqa: BLE001 — keep sampling the rest
                        probe = None
                        duty = {"duty_cycle": None, "probe_ms": None,
                                "probe_base_ms": None}
                else:
                    # A stop mid-interval still ends in a sample of it, as the
                    # JAX monitor's probe window always does: a command shorter
                    # than one interval leaves one sample, not none.
                    self._stop.wait(self.interval_s)
                total, idle = _cpu_times()
                dt, di = total - prev_total, idle - prev_idle
                prev_total, prev_idle = total, idle
                devices = sample_devices(self.device)
                if duty is not None:
                    devices[0].update(duty)
                rec = {"ts": round(time.time(), 3),
                       "cpu_pct": round(100.0 * (1.0 - di / dt) if dt > 0 else 0.0, 1),
                       "devices": devices}
                if duty is not None:
                    rec.update(duty)
                fh.write(json.dumps(rec) + "\n")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
