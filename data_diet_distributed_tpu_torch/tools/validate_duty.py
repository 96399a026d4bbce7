"""Sanity check of the duty-cycle probe on the card.

The port's copy of ``tools/validate_duty.py``: the same phases, arguments and
JSON keys, run without JAX::

    python -m data_diet_distributed_tpu_torch.tools.validate_duty [--out duty.json]

Drives the port's ``obs/monitor.py::ResourceMonitor`` against a controlled
load: ``--idle-s`` idle, ``--busy-s`` of saturating device work, ``--idle-s``
idle again, then prints one JSON line with the mean duty cycle the monitor
recorded in each phase (``n_samples``, ``devices``, ``platform``,
``duty_idle_pre``, ``duty_busy``, ``duty_idle_post``, ``per_device_busy``). A
healthy probe reads ~0 idle and ~1 saturated.

The load is a chain of ``MATMULS_PER_BLOCK`` bf16 matmuls, each of
``MATMUL_BATCH`` products of ``--dim``² in one kernel (on the card one
CUDA-graph replay a block), enqueued asynchronously with the host thread
asleep ``SLEEP_S`` between enqueues so the monitor's thread gets the
interpreter lock. One block is timed first, and each enqueue holds enough
blocks for more than the sleep, so the device never drains between
enqueues; at most two enqueues are in flight (the host waits on the older
one's event, which releases the lock). The kernels are few and long,
because a stream holds a bounded number of pending launches: with one
4096² product a kernel (~0.18 ms each on an H100) the busy phase read only
0.725.
``platform`` is ``cuda`` or ``cpu``;
on the CPU (``--device cpu``) the monitor has no device to probe and every
duty is null. Without a card and without ``--device cpu`` the tool exits
non-zero.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import os
import tempfile
import time

#: Matmuls a block, the unit the load enqueues.
MATMULS_PER_BLOCK = 10
#: Products of ``--dim``² one matmul kernel computes (a batched matmul).
MATMUL_BATCH = 16
#: The host's sleep between enqueues (the JAX tool's).
SLEEP_S = 0.25
#: Device work an enqueue holds, in sleeps.
ENQUEUE_OVER_SLEEP = 1.5


class _Load:
    """The saturating load on one device: ``y <- y @ w`` ``MATMULS_PER_BLOCK``
    times a block from the same ``x`` (``MATMUL_BATCH`` x ``dim`` x ``dim``),
    ``w`` scaled so ``y`` stays finite."""

    def __init__(self, device, dim: int):
        import torch
        self.device = device
        gen = torch.Generator().manual_seed(0)
        self.w = (torch.randn(dim, dim, generator=gen) / math.sqrt(dim)).to(
            device, torch.bfloat16)
        self.x = torch.randn(MATMUL_BATCH, dim, dim, generator=gen).to(device,
                                                                       torch.bfloat16)
        self.graph = None
        if device.type == "cuda":
            self._block()   # cuBLAS's workspace before the capture
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                self._block()
            torch.cuda.current_stream(device).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self._block()

    def _block(self) -> None:
        y = self.x
        for _ in range(MATMULS_PER_BLOCK):
            y = y @ self.w
        self.y = y

    def block(self) -> None:
        if self.graph is not None:
            self.graph.replay()
        else:
            self._block()

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def block_s(self) -> float:
        """One block's wall, enqueue to completion."""
        self.block()
        self.sync()
        t0 = time.perf_counter()
        self.block()
        self.sync()
        return time.perf_counter() - t0


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=None)
    parser.add_argument("--idle-s", type=float, default=3.0)
    parser.add_argument("--busy-s", type=float, default=6.0)
    parser.add_argument("--dim", type=int, default=4096,
                        help="matmul size for the saturating load")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import torch

    from ..device import resolve_device
    from .autotune import device_error
    from ..obs.monitor import ResourceMonitor

    err = device_error(args.device)
    if err:
        raise SystemExit(f"[validate_duty] {err}")
    device = resolve_device(args.device)
    load = _Load(device, args.dim)
    block_s = load.block_s()
    per_enqueue = max(1, math.ceil(ENQUEUE_OVER_SLEEP * SLEEP_S / block_s))

    fd, path = tempfile.mkstemp(suffix=".jsonl")
    os.close(fd)
    t_start = time.time()
    with ResourceMonitor(path, interval_s=0.5, device=device):
        time.sleep(args.idle_s)
        t_busy0 = time.time()
        in_flight: collections.deque = collections.deque()
        while time.time() - t_busy0 < args.busy_s:
            for _ in range(per_enqueue):
                load.block()
            if device.type == "cuda":
                done = torch.cuda.Event()
                done.record()
                in_flight.append(done)
                if len(in_flight) > 2:
                    in_flight.popleft().synchronize()
            time.sleep(SLEEP_S)     # the interpreter lock for the monitor
        load.sync()                 # the queue drains inside the busy window
        t_busy1 = time.time()
        time.sleep(args.idle_s)
    t_end = time.time()

    with open(path) as fh:
        recs = [json.loads(line) for line in fh if line.strip()]
    os.unlink(path)

    def phase_duty(lo, hi):
        vals = [r["duty_cycle"] for r in recs
                if r.get("duty_cycle") is not None and lo <= r["ts"] <= hi]
        return round(sum(vals) / len(vals), 3) if vals else None

    result = {
        "n_samples": len(recs),
        "devices": 1,
        "platform": device.type,
        "duty_idle_pre": phase_duty(t_start, t_busy0 - 0.5),
        "duty_busy": phase_duty(t_busy0 + 0.5, t_busy1 - 0.5),
        "duty_idle_post": phase_duty(t_busy1 + 1.0, t_end),
        "per_device_busy": [
            d.get("duty_cycle") for r in recs for d in r.get("devices", [])
            if t_busy0 + 0.5 <= r["ts"] <= t_busy1 - 0.5][:8],
        "block_ms": round(block_s * 1e3, 3),
        "blocks_per_enqueue": per_enqueue,
    }
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return result


if __name__ == "__main__":
    main()
