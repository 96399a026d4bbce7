#!/usr/bin/env python3
"""Where a training step of the PyTorch port spends its time, on one CUDA card.

    python3 tools/train_step_profile.py [--steps 10] [--batch 128] [--out DIR]

Runs ``train.steps.train_step`` on full-width ResNet-18 (bf16, the
``configs/cifar10_resnet18.yaml`` recipe) over device-resident synthetic
CIFAR-10-geometry batches. Prints the host wall per step (CUDA-synchronized,
after warm-up), then profiles ``--steps`` steps with ``torch.profiler``: device
time per step (the sum of the CUDA kernels' times), the device-busy share of
the profiled wall, kernel launches per step, the top kernels by device time
and the top host-side ops by self time. The tables go to
``<out>/train_step_profile.txt``. (``chip_smoke.py``'s train phase holds the
step against the CPU and float64.)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _cfg(load_config, *over):
    return load_config(os.path.join(REPO, "configs", "cifar10_resnet18.yaml"), [
        "data.dataset=synthetic", "data.synthetic_size=2560", "score.pretrain_epochs=0",
        *over])


def profile(torch, args) -> dict:
    from torch.profiler import ProfilerActivity, profile as tprofile

    from data_diet_distributed_tpu_torch.config import load_config
    from data_diet_distributed_tpu_torch.data.pipeline import ResidentBatches
    from data_diet_distributed_tpu_torch.device import set_scoring_determinism
    from data_diet_distributed_tpu_torch.models import create_model_from_cfg
    from data_diet_distributed_tpu_torch.train.loop import load_data_for
    from data_diet_distributed_tpu_torch.train.state import (create_train_state,
                                                             make_optimizer)
    from data_diet_distributed_tpu_torch.train.steps import train_step

    set_scoring_determinism()
    cfg = _cfg(load_config, f"data.batch_size={args.batch}")
    ds, _ = load_data_for(cfg)
    model = create_model_from_cfg(cfg).to("cuda")
    state = create_train_state(cfg, 0, "cuda", model)
    sgd = make_optimizer(cfg, 20)
    batches = list(ResidentBatches(ds, args.batch, "cuda", torch.bfloat16)())

    def steps(n):
        for i in range(n):
            train_step(model, sgd, state, batches[i % len(batches)])

    steps(5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps(args.steps)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / args.steps
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps(args.steps)
        torch.cuda.synchronize()
        prof_wall_ms = 1e3 * (time.perf_counter() - t0) / args.steps
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    device_ms = sum(e.device_time for e in events) / 1e3 / args.steps
    averages = prof.key_averages()
    table_dev = averages.table(sort_by="self_device_time_total", row_limit=25)
    table_cpu = averages.table(sort_by="self_cpu_time_total", row_limit=25)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "train_step_profile.txt"), "w") as fh:
        fh.write(table_dev + "\n\n" + table_cpu + "\n")
    kernels = [a for a in averages if a.device_type.name == "CUDA"]
    top = sorted(((a.key[:100], a.self_device_time_total / 1e3 / args.steps,
                   a.count / args.steps) for a in kernels), key=lambda t: -t[1])[:12]
    return {"batch": args.batch, "wall_ms_per_step": wall_ms,
            "profiled_wall_ms_per_step": prof_wall_ms,
            "device_ms_per_step": device_ms,
            "device_busy_share": device_ms / prof_wall_ms,
            "kernel_launches_per_step": len(events) / args.steps,
            "top_device_ops": [{"op": k, "ms_per_step": round(ms, 4),
                                "calls_per_step": c} for k, ms, c in top]}


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--out", default=os.path.join(REPO, "chip_smoke_out"))
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("train_step_profile: CUDA is not available", file=sys.stderr)
        return 1
    print(f"device {torch.cuda.get_device_name(0)}", flush=True)
    print(json.dumps({"profile": profile(torch, args)}, indent=1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
