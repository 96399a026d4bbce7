"""Program introspection: FLOPs per program, MFU and device-memory watermarks
(counterpart of ``data_diet_distributed_tpu/obs/xla.py``; record kinds and
gauge names are the JAX package's: ``xla_program``, ``hbm_watermark``,
``xla_*:<program>``, ``mfu:<program>``, ``mfu``).

* ``Introspector.call`` runs a program's call and, the FIRST time it sees a
  (program, geometry) key, counts that real call: it runs under
  ``torch.utils.flop_counter.FlopCounterMode`` (no extra call, so no state
  moves and the run stays bitwise the uninstrumented one) and under
  ``ops/kernels.observe_work``, which adds each hand-written kernel
  function's analytic work (``kernels.kernel_work``) and takes the counter's
  reading over that call out: the count is the same whether the CUDA kernel
  or its plain version ran. ``flops_source`` says how the count was made.
  ``compile_s`` is the call's wall up to ``torch.cuda.synchronize()``; on
  CUDA ``peak_bytes`` is the allocator's peak over the call and
  ``temp_bytes`` that peak above the bytes allocated before it;
  ``bytes_accessed`` has no counter here and stays null. The programs are
  ``train_step`` and ``score_batch`` (one scoring batch) on the per-step
  path, and the chunked engine's ``train_chunk``, ``eval_chunk`` and
  ``score_chunk``: on the card the eager warm-up body before a capture (one
  step or batch; a score chunk's on its plain route), never the capture or
  a replay; on the CPU the first chunk, run eagerly.
* MFU: ``note_throughput(program, examples_per_s)`` publishes
  ``examples_per_s × flops_per_example / (peak × ranks)`` as ``mfu:<program>``
  and ``mfu``. The peak per device resolves from ``DDT_PEAK_FLOPS_PER_DEVICE``,
  else ``PEAK_FLOPS_PER_DEVICE`` by ``torch.cuda.get_device_name()``, else a
  one-shot matmul calibration timed on the device (bf16 on CUDA with CUDA
  events, fp32 on the CPU, as the JAX package's CPU lane); the source
  (``env`` | ``table:<name>`` | ``calibrated`` | ``unknown``) is recorded
  beside the number.
* ``HbmMonitor.poll`` reads ``torch.cuda.memory_stats(device)`` (allocated
  bytes, current and peak) into ``hbm_bytes_in_use`` / ``hbm_peak_bytes``,
  with an ``hbm_watermark`` record and a flight-recorder entry on each peak
  jump of at least ``jump_frac``. On the CPU it disables itself after one
  empty poll; on CUDA a poll without the allocator's keys records nulls and
  stops.

The module-level helpers are no-ops until an introspector is installed, and
introspection never raises into the run: a harvest that fails records its
error with null fields.
"""

from __future__ import annotations

import os
import time
from typing import Any

from . import flightrec
from . import registry as obs_registry

__all__ = ["Introspector", "HbmMonitor", "device_peak_flops", "PEAK_FLOPS_PER_DEVICE",
           "install", "uninstall", "current", "call", "note_throughput", "poll_memory"]

#: Dense bf16 peak FLOP/s per device by ``torch.cuda.get_device_name()`` (the
#: compute dtype the port trains in). NVIDIA H100 SXM5 80 GB: 989.4 TFLOP/s
#: dense BF16 Tensor Core (NVIDIA H100 Tensor Core GPU data sheet). Other
#: parts calibrate.
PEAK_FLOPS_PER_DEVICE = {"NVIDIA H100 80GB HBM3": 989e12}

#: Calibration matmul edge and repeats (the fastest repeat counts).
_CALIBRATE_N = {"cuda": 8192, "cpu": 512}
_CALIBRATE_REPEATS = 3


def _float_or_none(v) -> float | None:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    return f if f == f else None


def device_peak_flops(device=None) -> tuple[float | None, str]:
    """``(peak FLOP/s per device, source)`` for ``device`` (default: CUDA
    when available)."""
    env = os.environ.get("DDT_PEAK_FLOPS_PER_DEVICE")
    if env:
        val = _float_or_none(env)
        if val and val > 0:
            return val, "env"
    import torch
    dev = torch.device(device) if device is not None else torch.device(
        "cuda" if torch.cuda.is_available() else "cpu")
    if dev.type == "cuda":
        name = torch.cuda.get_device_name(dev)
        if name in PEAK_FLOPS_PER_DEVICE:
            return PEAK_FLOPS_PER_DEVICE[name], f"table:{name}"
    try:
        return _calibrate_peak_flops(dev), "calibrated"
    except Exception:   # noqa: BLE001 — no peak is better than a crash
        return None, "unknown"


def _calibrate_peak_flops(dev) -> float:
    import torch
    n = _CALIBRATE_N[dev.type]
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    a = torch.ones((n, n), dtype=dtype, device=dev)
    best = float("inf")
    if dev.type == "cuda":
        torch.mm(a, a)
        for _ in range(_CALIBRATE_REPEATS):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            torch.mm(a, a)
            stop.record()
            stop.synchronize()
            best = min(best, start.elapsed_time(stop) / 1e3)
    else:
        torch.mm(a, a)
        for _ in range(_CALIBRATE_REPEATS):
            t0 = time.perf_counter()
            torch.mm(a, a)
            best = min(best, time.perf_counter() - t0)
    return 2.0 * n * n * n / best


def _tensor_bytes(obj, seen: set | None = None) -> int:
    """Bytes of the tensors in ``obj`` (tensors, mappings, sequences and
    dataclasses such as ``TrainState``), each storage once."""
    import dataclasses

    import torch
    seen = set() if seen is None else seen
    if isinstance(obj, torch.Tensor):
        key = (obj.device, obj.data_ptr())
        if key in seen:
            return 0
        seen.add(key)
        return obj.numel() * obj.element_size()
    if id(obj) in seen:
        return 0
    seen.add(id(obj))
    if isinstance(obj, dict):
        return sum(_tensor_bytes(v, seen) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_tensor_bytes(v, seen) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(_tensor_bytes(getattr(obj, f.name), seen)
                   for f in dataclasses.fields(obj))
    return 0


class _Counter:
    """One harvest's counters: ``FlopCounterMode`` over the call, the kernel
    functions' analytic FLOPs, and the counter's reading over them (taken out,
    so a plain version's ops on the CPU are not counted twice)."""

    def __init__(self):
        from torch.utils.flop_counter import FlopCounterMode
        self.mode = FlopCounterMode(display=False)
        self.kernel_flops = 0.0
        self.inside_kernels = 0

    def observe(self, kernel: str, flops: float, run):
        before = self.mode.get_total_flops()
        out = run()
        self.inside_kernels += self.mode.get_total_flops() - before
        self.kernel_flops += flops
        return out

    def total(self) -> float:
        return float(self.mode.get_total_flops() - self.inside_kernels + self.kernel_flops)


class Introspector:
    """Harvest and publish per-program FLOPs, walls and memory.

    ``logger`` receives one ``{"kind": "xla_program"}`` record per harvested
    (program, geometry); the gauges (``xla_flops:<p>``,
    ``xla_compile_s:<p>``, ``xla_peak_bytes:<p>``, ``mfu:<p>``, ``mfu``) land
    in the installed registry."""

    def __init__(self, logger=None, device=None, enabled: bool = True):
        self.logger = logger
        self.device = device
        self.enabled = enabled
        self._seen: set[tuple[str, Any]] = set()
        self.programs: dict[str, dict] = {}
        self._peak: tuple[float | None, str] | None = None

    # ------------------------------------------------------------- harvest

    def call(self, name: str, fn, args: tuple, kwargs: dict, key: Any,
             examples: int | None = None):
        """``fn(*args, **kwargs)``, counted the first time ``(name, key)``
        is seen. An exception of ``fn`` propagates; one of the counting does
        not."""
        if not self.enabled or (name, key) in self._seen:
            return fn(*args, **kwargs)
        self._seen.add((name, key))
        import torch
        from ..ops import kernels
        try:
            counter = _Counter()
        except Exception as exc:   # noqa: BLE001 — introspection never crashes a run
            self._record_error(name, key, exc)
            return fn(*args, **kwargs)
        cuda = self.device is not None and torch.device(self.device).type == "cuda"
        base = None
        if cuda:
            poll_memory()   # the watermark up to here, before the peak is reset
            torch.cuda.synchronize(self.device)
            base = torch.cuda.memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        with counter.mode, kernels.observe_work(counter.observe):
            out = fn(*args, **kwargs)
        if cuda:
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        try:
            peak = temp = None
            if cuda:
                peak = int(torch.cuda.max_memory_allocated(self.device))
                temp = max(0, peak - int(base))
            self._publish(name, key, examples, counter, wall, peak, temp,
                          _tensor_bytes(args) + _tensor_bytes(kwargs),
                          _tensor_bytes(out))
        except Exception as exc:   # noqa: BLE001
            self._record_error(name, key, exc)
        return out

    def _record_error(self, name, key, exc) -> None:
        rec = {"program": name, "geometry": str(key), "compile_s": None,
               "flops": None, "bytes_accessed": None, "peak_bytes": None,
               "error": repr(exc)[:200]}
        self.programs.setdefault(name, rec)
        if self.logger is not None:
            self.logger.log("xla_program", **rec)

    def _publish(self, name, key, examples, counter: _Counter, wall, peak, temp,
                 arg_bytes, out_bytes) -> None:
        flops = counter.total()
        rec: dict[str, Any] = {
            "program": name, "geometry": str(key), "compile_s": round(wall, 4),
            "flops": flops, "flops_source": (
                "flop_counter+kernel_work" if counter.kernel_flops else "flop_counter"),
            "kernel_flops": counter.kernel_flops,
            "bytes_accessed": None, "arith_intensity": None,
            "argument_bytes": arg_bytes, "output_bytes": out_bytes,
            "temp_bytes": temp, "peak_bytes": peak,
        }
        if examples:
            rec["examples"] = int(examples)
            if flops:
                rec["flops_per_example"] = flops / examples
        self.programs[name] = rec
        for g, v in (("flops", flops), ("compile_s", wall), ("peak_bytes", peak)):
            if v is not None:
                obs_registry.set_gauge(f"xla_{g}:{name}", v)
        if self.logger is not None:
            self.logger.log("xla_program", **rec)

    # ----------------------------------------------------------------- MFU

    def peak_flops_per_device(self) -> tuple[float | None, str]:
        if self._peak is None:
            self._peak = device_peak_flops(self.device)
            if self._peak[0] is not None:
                obs_registry.set_gauge("xla_peak_flops_per_device", self._peak[0])
        return self._peak

    def note_throughput(self, name: str, examples_per_s: float) -> float | None:
        """MFU of ``name`` at ``examples_per_s`` (global examples a second,
        over every rank): achieved FLOP/s over the peak of the ranks'
        devices. None when the program was not harvested or no peak is
        known."""
        if not self.enabled:
            return None
        rec = self.programs.get(name)
        fpe = rec.get("flops_per_example") if rec else None
        if not fpe or not examples_per_s or examples_per_s <= 0:
            return None
        peak, _source = self.peak_flops_per_device()
        if not peak:
            return None
        from ..parallel.mesh import world_size
        mfu = examples_per_s * fpe / (peak * world_size())
        obs_registry.set_gauge(f"mfu:{name}", mfu)
        obs_registry.set_gauge("mfu", mfu)
        return mfu

    def summary(self) -> dict[str, dict]:
        """Per-program records for the ``run_summary`` ``xla`` block."""
        return {name: {k: rec.get(k) for k in
                       ("geometry", "flops", "flops_source", "kernel_flops",
                        "bytes_accessed", "compile_s", "peak_bytes", "temp_bytes",
                        "arith_intensity", "flops_per_example", "error")
                       if rec.get(k) is not None}
                for name, rec in self.programs.items()}


class HbmMonitor:
    """Device-memory watermarks from ``torch.cuda.memory_stats``."""

    def __init__(self, logger=None, jump_frac: float = 0.10, device=None):
        self.logger = logger
        self.jump_frac = jump_frac
        self.device = device
        self._disabled = False
        self._last_peak = 0.0
        self.peak = 0.0   # the largest peak any poll saw (the allocator's resets aside)

    def poll(self) -> dict | None:
        if self._disabled:
            return None
        try:
            return self._poll()
        except Exception:   # noqa: BLE001 — observation must not kill the run
            self._disabled = True
            return None

    def _poll(self) -> dict | None:
        import torch
        dev = torch.device(self.device) if self.device is not None else None
        if dev is None or dev.type != "cuda":
            self._disabled = True   # the CPU has no allocator statistics
            return None
        stats = torch.cuda.memory_stats(dev)
        in_use = _float_or_none(stats.get("allocated_bytes.all.current"))
        peak = _float_or_none(stats.get("allocated_bytes.all.peak"))
        if in_use is None or peak is None:
            rec = {"device": str(dev), "bytes_in_use": None, "peak_bytes": None,
                   "prev_peak_bytes": int(self._last_peak)}
            flightrec.record("hbm_watermark", **rec)
            if self.logger is not None:
                self.logger.log("hbm_watermark", **rec)
            self._disabled = True
            return None
        self.peak = max(self.peak, peak)
        obs_registry.set_gauge("hbm_bytes_in_use", in_use)
        obs_registry.set_gauge("hbm_peak_bytes", self.peak)
        if self._last_peak == 0.0 or self.peak >= self._last_peak * (1.0 + self.jump_frac):
            rec = {"device": str(dev), "bytes_in_use": int(in_use),
                   "peak_bytes": int(self.peak), "prev_peak_bytes": int(self._last_peak)}
            flightrec.record("hbm_watermark", **rec)
            if self.logger is not None:
                self.logger.log("hbm_watermark", **rec)
            self._last_peak = self.peak
        return {"device": str(dev), "bytes_in_use": in_use, "peak_bytes": self.peak}


# --------------------------------------------------------- module-level slot

_INTROSPECTOR: Introspector | None = None
_HBM: HbmMonitor | None = None


def install(introspector: Introspector, hbm: HbmMonitor | None = None) -> Introspector:
    global _INTROSPECTOR, _HBM
    _INTROSPECTOR = introspector
    _HBM = hbm
    return introspector


def uninstall() -> None:
    global _INTROSPECTOR, _HBM
    _INTROSPECTOR = None
    _HBM = None


def current() -> Introspector | None:
    return _INTROSPECTOR


def call(name: str, fn, args: tuple, kwargs: dict | None = None, key: Any = None,
         examples: int | None = None):
    """``fn(*args, **kwargs)``, harvested once per (name, key) when an
    introspector is installed."""
    kwargs = kwargs or {}
    if _INTROSPECTOR is None:
        return fn(*args, **kwargs)
    return _INTROSPECTOR.call(name, fn, args, kwargs, key, examples)


def note_throughput(name: str, examples_per_s: float) -> float | None:
    if _INTROSPECTOR is not None:
        return _INTROSPECTOR.note_throughput(name, examples_per_s)
    return None


def poll_memory() -> dict | None:
    if _HBM is not None:
        return _HBM.poll()
    return None
