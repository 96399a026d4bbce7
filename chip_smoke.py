#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py                # from the repo root, on a machine with a CUDA card
    python3 chip_smoke.py --profile      # also profile GraNd batches (torch.profiler)
    python3 chip_smoke.py --out DIR      # where the detail files go (default chip_smoke_out/)

Phases (the first failure exits non-zero; nothing is caught):

1. Device: require CUDA; print ``nvidia-smi --query-gpu=name,power.limit``.
2. Build: compile every hand-written kernel from ``ops/csrc`` (one nvcc per
   source, in parallel) and print the build seconds and ptxas resource lines;
   the tensor-core (bf16) modes of the direct, megakernel and cat-dot kernels,
   and the Gram kernel and the stacked-BN vector mode in both dtypes, must not
   spill registers.
3. Kernels: hold each kernel against its plain PyTorch version at every
   ResNet-18 main-path geometry with B=512, in fp32 (TF32 off, rtol 1e-4) and
   bf16 (the same bf16 inputs on both sides, rtol 1e-3); time both. ``ms`` is
   one call between CUDA events (median after warm-up; the wrapper's host
   time included), ``device_ms`` the kernel's device time per launch over a
   run of ``RUN_LAUNCHES`` launches replayed from a CUDA graph (the host out
   of the run); rows whose inputs fit the 50 MB L2 say so (``l2_warm``), and
   the Gram and stacked-BN ones are also timed cold (``device_cold_ms``,
   cycling through input copies that exceed L2). The direct and Gram kernels
   also at ragged geometries (batch 37; not in the per-batch sums), and the
   Gram kernel at GROUP_CONV's batch 1,536; each bitwise equal on a
   permutation of the batch and from run to run, with ``torch.bmm``'s bf16
   time of the same product Pᵀ G (im2col patches P made outside the timed
   call) beside each direct geometry as a yardstick (``bmm_ms``).
   EL2N at logits [512, 10] and [512, 1000] and the route kernels likewise:
   last-layer GraNd at [512, 512] -> 10 and [512, 2048] -> 1000 (with the fp32
   ``F.linear`` of the same product as a yardstick, ``linear_ms``); both take
   the working dtype and int64 labels as given and are bitwise from run to
   run, on a permuted batch and on a 5-row slice (that each call launches one
   CUDA kernel and nothing else is checked under ``torch.profiler`` after the
   timed phases, phase 10: the profiler slows every later launch of the
   process); stacked BatchNorm at the four ResNet-18 BN shapes
   singly and 5 deep (every launch in the ``vector`` mode) and at ragged rows
   (``BN_RAGGED``: batch 37, C = 72, 100 and 98, S = 1, use_scale and use_bias
   off in turn), bitwise from run to run and on a permuted batch, cat-dot
   (``CATDOT_GEOMETRIES``: 16x16x128 and ragged ones at batch 37) with the
   direct kernel's time at the same layer as a yardstick (``direct_ms``), the
   megakernel (``MEGA_GEOMETRIES``: the stage-1/2/3 unit-stride geometries and
   ragged ones; its bf16 ``dx`` within two bf16 ulps, see ``MEGA_DX_TOL``)
   with a cuDNN input gradient plus the direct kernel's time as yardsticks
   (``dgrad_ms``, ``direct_ms``). Each launch of the direct, Gram, cat-dot
   and megakernel kernels is counted in the mode its dtype selects, and each
   stacked-BN launch in the mode ``bn_mode`` names; in bf16 each is bitwise
   equal from run to run and on a permuted batch, and the megakernel's norm
   bitwise equal to the direct kernel's.
4. Path: full-width ResNet-18 on CIFAR-10-geometry synthetic data (8192
   examples, seeds [0, 1], batch 512, bf16) through ``score_dataset`` for
   ``el2n`` and ``grand``; check finite scores, the launch counts (12 direct,
   all in the tensor-core mode, 3 Gram, 1 EL2N per batch per seed) and ex/s;
   then, on BN-randomized fp32 weights with TF32 off, the kernel route (direct
   launches in the fp32 mode) against the plain route end to end.
5. Routes: every GraNd route (``ROUTES``: ``grand_last_layer`` and the
   ``DDT_GRAND_*`` toggles, set as module attributes and restored) at the
   same width on 1024 examples x 2 seeds: exact launch counts per batch per
   seed (every direct, Gram, cat-dot and megakernel launch in the tensor-core
   mode, every stacked-BN launch in the vector mode, and every BatchNorm x and
   g an NHWC view, so the BN routes copy nothing), ex/s; on BN-randomized
   fp32 weights with TF32 off (every such launch in the fp32 mode, BN in the
   vector mode) each route against
   the default two-phase route (rtol 1e-4), and ``grand_vmap`` on 64 examples
   against it (rtol 2e-4, atol 1e-5); both against float64 (rtol 1e-4).
6. Serve: ``ServeEngine`` answers ``score_batch`` for 1, 100 and 512 ids
   bitwise equal to ``full_scores``, plus ``topk`` and ``rank``, for both
   methods; the keep-hardest count at sparsity 0.5. Then ``grand_last_layer``
   (kernel route) and ``grand`` on the fused megakernel route, bitwise too.
7. ResNet-50: ``create_model("resnet50", 100)`` on synthetic CIFAR-100-geometry
   data (1,024 examples, one seed, batch 512, bf16) through ``score_dataset``
   for ``el2n`` and ``grand_last_layer``: one launch of the kernel a batch,
   finite scores, ex/s; then in fp32 (TF32 off) the kernel route against the
   plain route (rtol 1e-4 for ``grand_last_layer``, rel 1e-5 or abs 1e-6 for
   EL2N).
8. Train: full-width ResNet-18 through the port's training slice, bf16,
   batch 128, on synthetic CIFAR-10-geometry data. A 2-epoch ``fit`` on
   ``TRAIN_N`` examples with eval (each epoch's ex/s, the steady step ms, the
   eval rate; loss falls, test accuracy above 1/10 + ``TRAIN_ACC_MARGIN``);
   two 20-step fits from one seed bitwise equal, and the step timed with
   cuDNN's deterministic and autotuned algorithms; fit(2) bitwise equal to
   fit(1) + a resume for 1 more through the port's checkpoint
   (``RESUME_N`` examples, augmented); 3 fp32 steps (TF32 off, one padded
   tail) on the card, on the CPU and on the CPU in float64: losses within
   rtol 1e-5 of the CPU's, variables within rtol 1e-4 and an atol of twice
   the CPU fp32 run's largest distance from float64 (floor 1e-6), the card
   no farther from float64; the north-star ``run``
   (``configs/cifar10_resnet18_grand10.yaml`` at ``TRAIN_N`` examples, seeds
   [0, 1], 2 retrain epochs): its stage walls, 12 direct and 3 Gram launches
   per batch per seed in the tensor-core mode, ``n_kept`` half the set, the
   prune manifest verified, a finite final accuracy; then on its pretrained
   seed-0 weights in fp32 each kernel route (``el2n``, ``grand``,
   ``grand_last_layer``, train-mode ``el2n``) against its plain route (rtol
   1e-4; EL2N + atol 1e-6). Cuts: 8,192 of CIFAR-10's 50,000 examples, 2 of
   the recipes' 198 epochs, 2 of the north star's 10 seeds; widths as
   published.
9. Resilience: on the north-star ``run`` of phase 8 (its own directory), A:
   a fault plan SIGTERMs after seed 0's score partial -> ``Preempted``, seed 0's
   partial on disk, ``score`` not complete; the re-invoked run pretrains and
   scores seed 1 only (12 direct and 3 Gram launches per batch, tensor-core)
   and its scores, kept set and final retrain arrays are bitwise phase 8's.
   B: the same config reusing A's scores, SIGTERM at epoch 0's end ->
   ``Preempted`` durable at one epoch of steps; the re-invoked run resumes
   ``retrain:final`` there and ends bitwise equal to A's retrain, launching
   nothing. F: B's newest step truncated, a resumed fit refuses it
   (``checkpoint_corrupt``), falls back one step and ends bitwise equal to B.
   On ``RESUME_N`` examples of the recipe: C, SIGTERM before step 2 -> a final
   save at step 3 (``preempted``, epoch -1), the resume ending at step 3 + 2
   epochs; D, NaN at epoch 1 -> one ``divergence``, a rollback to epoch 0's
   step at half the LR, bitwise a resume by hand; E, a 600-s hang in epoch 1
   with ``resilience.step_timeout_s`` = ``HANG_TIMEOUT_S`` -> one ``hang``
   (``WatchdogTimeout``) and a retry, under ``HANG_WALL_S`` of wall, bitwise
   an uninterrupted fit. G: ``python -m data_diet_distributed_tpu_torch.cli
   run`` at ``G_N`` examples exits 75 with ``[preempted]`` under
   ``DDT_FAULT_PLAN`` and 0 without it (``n_kept`` half). Then the hooks'
   cost: ``OVERHEAD_PAIRS`` alternating pairs of fit's steady-epoch ex/s with
   resilience at its defaults and with preemption and the NaN check off.
10. Calls: each EL2N and last-layer row of phase 3 runs one CUDA kernel per
   call, its own, and no copy, cast or memset (``torch.profiler``).

With ``--profile``: one batch under ``torch.profiler`` on each of the default,
FUSED+MEGAKERNEL, BN_KERNEL and BN_KERNEL+GROUP_BN+GROUP_CONV routes; the cuDNN
dgrad launches must drop from 19 to 9 on the megakernel route, and the
profiled BN and Gram time per batch is printed beside the ``device_ms`` sums.

Every counted run (phases 4, 5 and 7, phase 8's ``run`` and phase 9's runs of
``run_datadiet``) starts with the launch counts at 0 and is read right after;
the kernels line sums them. The line before the last is a
JSON object with one entry per kernel (launches on the main paths, max error,
ms, device ms, plain ms, bound ms); the last line is ``{"ok": true, "device":
{...}}``.
Per-geometry details go to ``<out>/chip_smoke.json`` (and the profile tables to
``<out>/chip_smoke_profile.txt``).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and FLOP/s by type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

B = 512
N_PATH = 8192
SEEDS = (0, 1)
PAD1 = ((1, 1), (1, 1))
PAD0 = ((0, 0), (0, 0))

# (kernel, entry, x shape, g shape, kernel size, strides, padding, layers of
# ResNet-18 at CIFAR-10 geometry with this shape, i.e. launches per GraNd batch, bias)
GEOMETRIES = [
    ("conv_grad_norm_direct", "v1", (B, 32, 32, 64), (B, 32, 32, 64), (3, 3), (1, 1), PAD1, 4,
     False),
    ("conv_grad_norm_direct", "v1", (B, 32, 32, 64), (B, 16, 16, 128), (3, 3), (2, 2), PAD1, 1,
     False),
    ("conv_grad_norm_direct", "v1", (B, 32, 32, 64), (B, 16, 16, 128), (1, 1), (2, 2), PAD0, 1,
     False),
    ("conv_grad_norm_direct", "v2", (B, 16, 16, 128), (B, 16, 16, 128), (3, 3), (1, 1), PAD1, 3,
     False),
    ("conv_grad_norm_direct", "v2", (B, 8, 8, 256), (B, 8, 8, 256), (3, 3), (1, 1), PAD1, 3,
     False),
    ("conv_grad_norm_gram", "gram", (B, 4, 4, 512), (B, 4, 4, 512), (3, 3), (1, 1), PAD1, 3,
     False),
    # The three stage-4 convs concatenated along the batch, as GROUP_CONV launches them
    # (one launch per batch on that route; not in the default route's per-batch sums).
    ("conv_grad_norm_gram", "gram", (3 * B, 4, 4, 512), (3 * B, 4, 4, 512), (3, 3), (1, 1),
     PAD1, 0, False),
    # Ragged direct geometries, on no ResNet-18 path: C and K off the 64 tile, a
    # strided 9x9 input, C not a multiple of 8, asymmetric padding; batch 37.
    ("conv_grad_norm_direct", "v2", (37, 12, 12, 72), (37, 12, 12, 136), (3, 3), (1, 1), PAD1, 0,
     False),
    ("conv_grad_norm_direct", "v1", (37, 9, 9, 48), (37, 5, 5, 80), (3, 3), (2, 2), PAD1, 0,
     False),
    ("conv_grad_norm_direct", "v1", (37, 10, 10, 20), (37, 10, 10, 24), (3, 3), (1, 1), PAD1, 0,
     False),
    ("conv_grad_norm_direct", "v1", (37, 11, 11, 64), (37, 11, 11, 40), (3, 3), (1, 1),
     ((0, 2), (2, 0)), 0, False),
    # Ragged Gram geometries at batch 37: C and K not multiples of 8 with the bias term
    # (scalar staging); a 5x5 map (25 positions, padded to 32) with asymmetric padding;
    # K = 4096, whose rows stream through the ring in chunks (gram_plan).
    ("conv_grad_norm_gram", "gram", (37, 4, 4, 100), (37, 4, 4, 70), (3, 3), (1, 1), PAD1, 0,
     True),
    ("conv_grad_norm_gram", "gram", (37, 5, 5, 64), (37, 5, 5, 64), (3, 3), (1, 1),
     ((0, 2), (2, 0)), 0, False),
    ("conv_grad_norm_gram", "gram", (37, 4, 4, 72), (37, 4, 4, 4096), (3, 3), (1, 1), PAD1, 0,
     True),
]
# Megakernel: (x shape, g shape, kernel size, padding, use_bias, layers per batch): the
# unit-stride 3x3 convs of stages 1-3 (megakernel route), then ragged geometries on no
# ResNet-18 path at batch 37 (C and K off the 64 tile; C and K not multiples of 8 with
# asymmetric padding; a (3, 2) kernel).
MEGA_GEOMETRIES = [((B, 32, 32, 64), (B, 32, 32, 64), (3, 3), PAD1, False, 4),
                   ((B, 16, 16, 128), (B, 16, 16, 128), (3, 3), PAD1, False, 3),
                   ((B, 8, 8, 256), (B, 8, 8, 256), (3, 3), PAD1, False, 3),
                   ((37, 12, 12, 72), (37, 12, 12, 136), (3, 3), PAD1, True, 0),
                   ((37, 10, 10, 20), (37, 10, 10, 30), (3, 3), ((0, 2), (2, 0)), False, 0),
                   ((37, 9, 11, 64), (37, 9, 11, 48), (3, 2), ((1, 1), (1, 0)), True, 0)]
# Cat-dot: (x shape, g shape, kernel size, padding, layers per batch): stage 2's
# unit-stride 3x3 conv (CATDOT route), then ragged ones at batch 37 (a non-square map
# with K = 256 and asymmetric padding; a (3, 2) kernel).
CATDOT_GEOMETRIES = [((B, 16, 16, 128), (B, 16, 16, 128), (3, 3), PAD1, 3),
                     ((37, 12, 10, 128), (37, 12, 10, 256), (3, 3), ((0, 2), (2, 0)), 0),
                     ((37, 9, 14, 128), (37, 9, 14, 128), (3, 2), ((1, 1), (1, 0)), 0)]
BN_SHAPES = [(B, 32, 32, 64), (B, 16, 16, 128), (B, 8, 8, 256), (B, 4, 4, 512)]
# Ragged stacked-BN rows at batch 37, on no ResNet-18 path: (x shape, layers, use_scale,
# use_bias). C = 72 takes the vector mode (9 vectors of 8 bf16); C = 100 the scalar
# mode in bf16 and the vector one in fp32; C = 98 the scalar mode in both; S = 1.
BN_RAGGED = [((37, 3, 3, 72), 3, True, True), ((37, 5, 5, 100), 3, True, False),
             ((37, 1, 1, 98), 3, False, True), ((37, 1, 1, 72), 1, True, True)]
# The megakernel's dx against the plain version's, elementwise:
# |dx - ref| <= rtol * |ref| + 1e-5 * max|ref|. fp32: rtol 1e-4. bf16 output:
# both sides round an fp32 sum of the same terms (in another order) to bf16,
# which can land one bf16 ulp (2^-8 relative) apart; rtol 2^-7 allows two.
MEGA_DX_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}

ROUTE_N = 1024
MEGA_ROUTE = {"FUSED_BWD": True, "MEGAKERNEL": True}
# Launch-table rows: (name, method, DDT_GRAND_* module attributes, launches
# per batch per seed).
ROUTES = [
    ("grand", "grand", {}, {"conv_grad_norm_direct": 12, "conv_grad_norm_gram": 3}),
    ("grand_last_layer", "grand_last_layer", {}, {"grand_last_layer": 1}),
    ("BN_KERNEL", "grand", {"USE_BN_KERNEL": True},
     {"conv_grad_norm_direct": 12, "conv_grad_norm_gram": 3, "bn_grad_norm": 20}),
    ("BN_KERNEL+GROUP_BN+GROUP_CONV", "grand",
     {"USE_BN_KERNEL": True, "GROUP_BN": True, "GROUP_CONV": True},
     {"conv_grad_norm_direct": 5, "conv_grad_norm_gram": 1, "bn_grad_norm": 4}),
    ("CATDOT", "grand", {"USE_CATDOT": True},
     {"conv_grad_norm_direct": 9, "conv_grad_norm_gram": 3, "conv_grad_norm_catdot": 3}),
    ("FUSED", "grand", {"FUSED_BWD": True},
     {"conv_grad_norm_direct": 12, "conv_grad_norm_gram": 3}),
    ("FUSED+MEGAKERNEL", "grand", MEGA_ROUTE,
     {"conv_grad_norm_direct": 2, "conv_grad_norm_gram": 3, "conv_bwd_grad_norm": 10}),
]

KERNEL_INFO = {
    "conv_grad_norm_direct": (
        "data_diet_distributed_tpu_torch/ops/csrc/conv_grad_norm_direct.cu",
        "data_diet_distributed_tpu/ops/pallas_kernels.py:327; "
        "data_diet_distributed_tpu/ops/pallas_kernels.py:683"),
    "conv_grad_norm_gram": (
        "data_diet_distributed_tpu_torch/ops/csrc/conv_grad_norm_gram.cu",
        "data_diet_distributed_tpu/ops/pallas_kernels.py:797"),
    "el2n": ("data_diet_distributed_tpu_torch/ops/csrc/el2n.cu",
             "data_diet_distributed_tpu/ops/pallas_kernels.py:100"),
    "grand_last_layer": ("data_diet_distributed_tpu_torch/ops/csrc/grand_last_layer.cu",
                         "data_diet_distributed_tpu/ops/pallas_kernels.py:933"),
    "bn_grad_norm": ("data_diet_distributed_tpu_torch/ops/csrc/bn_grad_norm.cu",
                     "data_diet_distributed_tpu/ops/pallas_kernels.py:883"),
    "conv_grad_norm_catdot": (
        "data_diet_distributed_tpu_torch/ops/csrc/conv_grad_norm_catdot.cu",
        "data_diet_distributed_tpu/ops/pallas_kernels.py:156"),
    "conv_bwd_grad_norm": ("data_diet_distributed_tpu_torch/ops/csrc/conv_bwd_grad_norm.cu",
                           "data_diet_distributed_tpu/ops/pallas_kernels.py:488"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def time_ms(torch, fn, warmup: int = 2, iters: int = 7) -> float:
    """Median time of one call, by CUDA events around it with the device idle
    before it: the wrapper's host time (checks, allocation, launch) included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


# Launches of one timed run (device_ms) and such runs whose median is taken.
RUN_LAUNCHES = 20
RUN_REPEATS = 3
# L2 cache of the H100: inputs of at most this many bytes are read warm in a run of
# launches on the same inputs.
L2_BYTES = 50 * 2**20


def device_ms(torch, fns, warmup: int = 3) -> float:
    """Device time per launch: a run of ``RUN_LAUNCHES`` back-to-back calls
    (cycling through ``fns``, one callable or a list of them on distinct
    input copies) captured once in a CUDA graph, then CUDA events around one
    replay of it, over the count; median of ``RUN_REPEATS`` replays after
    warm-up. The graph takes the wrapper's host time (checks, allocation,
    the ctypes call) out of the run, which for a short kernel is longer than
    the kernel: only the device's work and its launch gaps remain."""
    fns = fns if isinstance(fns, list) else [fns]
    n = max(RUN_LAUNCHES, len(fns))
    for i in range(max(warmup, len(fns))):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(RUN_REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / n)
    del graph
    return statistics.median(times)


def cold_copies(nbytes: float) -> int:
    """Input copies a cold run cycles through: enough that one cycle reads at
    least twice the L2 cache, so no launch finds its inputs there."""
    return int(-(-2 * L2_BYTES // nbytes)) + 1


def bound_ms(flops: float, nbytes: float, dtype_name: str) -> tuple[float, str]:
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def conv_work(kernel: str, xs, gs, ks, itemsize: int) -> tuple[float, float]:
    """FLOPs the kernel's algorithm needs and the bytes it must move (x and g
    read once, [B] fp32 out written once)."""
    b, h, w, c = xs
    _, ho, wo, k = gs
    s = ho * wo
    if kernel == "conv_grad_norm_direct":
        flops = 2.0 * b * ks[0] * ks[1] * s * c * k
    else:   # input-pixel Gram, cotangent Gram, offset gather and the final dot
        flops = 2.0 * b * ((h * w) ** 2 * c + s * s * k) + b * s * s * (ks[0] * ks[1] + 2)
    nbytes = (np.prod(xs) + np.prod(gs)) * itemsize + 4 * b
    return flops, float(nbytes)


def check_modes(K, before: dict, n: int, mode: str, what: str,
                kernel: str = "conv_grad_norm_direct") -> None:
    """Exactly ``n`` launches of ``kernel`` since ``before`` (its mode counts),
    all in ``mode``."""
    after = K.mode_counts()[kernel]
    delta = {m: after[m] - before[m] for m in after}
    want = {m: (n if m == mode else 0) for m in after}
    check(delta == want, f"{what}: {kernel} launches by mode {delta}, want {want}")


def route_mode(K, kernel: str, dtype) -> str:
    """The mode every launch of ``kernel`` takes on a ResNet-18 route in
    ``dtype``: the stacked-BN kernel's vector mode (every ResNet-18 channel
    count is a multiple of 8), else the mode the dtype selects."""
    return "vector" if kernel == "bn_grad_norm" else K.DIRECT_MODES[dtype]


def check_bitwise(torch, gen, call, x, g, got, what: str) -> None:
    """``call(x, g)`` (a tensor or a tuple of them, batch first) gives ``got``
    again bit for bit, and each example the same bits wherever it sits in the
    batch (a permutation)."""
    as_tuple = (lambda r: r if isinstance(r, tuple) else (r,))
    perm = torch.randperm(x.shape[0], generator=gen, device="cuda")
    again = as_tuple(call(x, g))
    moved = as_tuple(call(x[perm].contiguous(), g[perm].contiguous()))
    check(all(torch.equal(a, b) and torch.equal(m, b[perm])
              for a, m, b in zip(again, moved, as_tuple(got))),
          f"{what}: not bitwise equal from run to run and on a permuted batch")


def check_bn_bitwise(torch, gen, call, xs, gs, got, what: str) -> None:
    """``call(xs, gs)`` of the stacked-BN kernel gives ``got`` again bit for
    bit, and each example the same bits wherever it sits in its layer's batch
    (every layer permuted alike; out is [L·B], layer-major)."""
    b = xs[0].shape[0]
    perm = torch.randperm(b, generator=gen, device="cuda")
    again = call(xs, gs)
    moved = call([x[perm].contiguous() for x in xs], [g[perm].contiguous() for g in gs])
    want = got.reshape(len(xs), b)[:, perm].reshape(-1)
    check(torch.equal(again, got) and torch.equal(moved, want),
          f"{what}: not bitwise equal from run to run and on a permuted batch")


def check_rows_bitwise(torch, gen, call, args, got, what: str) -> None:
    """``call(*args)`` (every arg batch-first) gives ``got`` again bit for bit,
    on a permuted batch the permuted bits, and on a 5-row slice those rows'."""
    b = args[0].shape[0]
    perm = torch.randperm(b, generator=gen, device="cuda")
    again = call(*args)
    moved = call(*(a[perm].contiguous() for a in args))
    part = call(*(a[3:8].contiguous() for a in args))
    check(torch.equal(again, got) and torch.equal(moved, got[perm])
          and torch.equal(part, got[3:8]),
          f"{what}: not bitwise equal from run to run, on a permuted batch and on a "
          "5-row slice")


# (row record, description, kernel name, call): the one-call launch checks, run by
# ``calls_phase`` after the timed phases (the profiler slows every later launch of
# the process).
CALL_CHECKS: list = []


def kernels_per_call(torch, call) -> list[str]:
    """Names of the CUDA kernels (copies and memsets included) one warmed-up
    ``call()`` runs, under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def kernel_phase(torch, K, dtype, rtol, details) -> None:
    """Each kernel against its plain version at every main-path geometry."""
    dname = str(dtype).replace("torch.", "")
    gen = torch.Generator(device="cuda").manual_seed(1234)
    for kernel, entry, xs, gs, ks, st, pad, layers, bias in GEOMETRIES:
        x = torch.randn(xs, generator=gen, device="cuda").to(dtype)
        g = torch.randn(gs, generator=gen, device="cuda").to(dtype)
        if entry == "v1":
            def call(x, g):
                return K.conv_grad_norm_sq(x, g, ks, st, pad)

            def plain():
                return K.conv_grad_norm_sq_plain(x, g, ks, st, pad)
        elif entry == "v2":
            def call(x, g):
                return K.conv_grad_norm_sq_v2(x, g, ks, pad)

            def plain():
                return K.conv_grad_norm_sq_plain(x, g, ks, (1, 1), pad)
        else:
            def call(x, g, bias=bias):
                return K.conv_grad_norm_sq_gram(x, g, ks, pad, use_bias=bias)

            def plain():
                return K.conv_grad_norm_sq_gram_plain(x, g, ks, pad, use_bias=bias)

        def run():
            return call(x, g)
        what = f"{kernel}/{entry} {dname} x{list(xs)} g{list(gs)}"
        modes0 = K.mode_counts()[kernel]
        got = run()
        torch.cuda.synchronize()
        check_modes(K, modes0, 1, K.DIRECT_MODES[dtype], what, kernel)
        check_bitwise(torch, gen, call, x, g, got, what)
        ref = plain()
        err = (got - ref).abs()
        rel = float((err / ref.abs().clamp_min(1e-30)).max())
        flops, nbytes = conv_work(kernel, xs, gs, ks, x.element_size())
        bnd, by = bound_ms(flops, nbytes, dname)
        rec = {"kernel": kernel, "entry": entry, "dtype": dname, "x": list(xs),
               "g": list(gs), "kernel_size": list(ks), "strides": list(st),
               "padding": [list(p) for p in pad], "use_bias": bias,
               "layers_per_batch": layers, "max_abs_err": float(err.max()),
               "max_rel_err": rel, "ms": time_ms(torch, run), "device_ms": device_ms(torch, run),
               "plain_ms": time_ms(torch, plain, warmup=1, iters=3),
               "bound_ms": bnd, "bound_by": by, "input_bytes": nbytes,
               "l2_warm": nbytes <= L2_BYTES}
        if rec["l2_warm"] and kernel == "conv_grad_norm_gram":
            copies = [(x.clone(), g.clone()) for _ in range(cold_copies(nbytes))]
            rec["device_cold_ms"] = device_ms(torch, [lambda xc=xc, gc=gc: call(xc, gc)
                                                      for xc, gc in copies])
            del copies
        if kernel == "conv_grad_norm_direct" and dtype == torch.bfloat16:
            # Yardstick, not a library counterpart: one bf16 bmm of the same
            # product P^T G (no norm), with the patches P made outside the call.
            p = K.patches(x, ks, st, pad, gs[1:3]).to(dtype)
            g2 = g.reshape(gs[0], gs[1] * gs[2], gs[3])
            rec["bmm_ms"] = time_ms(torch, lambda: torch.bmm(p.transpose(1, 2), g2))
            del p
        details.append(rec)
        print(f"  {what} k{ks} s{st}: "
              f"rel_err={rel:.3e} (rtol {rtol}) ms={rec['ms']:.4f} "
              f"device_ms={rec['device_ms']:.4f}"
              + (f" (inputs {nbytes / 2**20:.1f} MiB fit L2; cold "
                 f"{rec['device_cold_ms']:.4f})" if "device_cold_ms" in rec else "")
              + f" plain_ms={rec['plain_ms']:.4f} bound_ms={bnd:.4f} ({by})"
              + (f" bmm_ms={rec['bmm_ms']:.4f}" if "bmm_ms" in rec else ""), flush=True)
        check(bool(torch.isfinite(got).all()), f"{what}: non-finite")
        check(rel <= rtol, f"{what}: max rel err {rel:.3e} > {rtol}")
    # EL2N at the path's logits geometry [512, 10] and a wide one [512, 1000]: the
    # logits in the working dtype itself, the labels int64, as a caller holds them.
    for c in (10, 1000):
        z = (torch.randn((B, c), generator=gen, device="cuda") * 3).to(dtype)
        y = torch.randint(0, c, (B,), generator=gen, device="cuda")
        m = (torch.rand(B, generator=gen, device="cuda") > 0.1).float()
        what = f"el2n {dname} logits[{B},{c}]"
        got, ref = K.el2n(z, y, m), K.el2n_plain(z, y, m)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        rel = float((err / ref.abs().clamp_min(1e-6)).max())
        check_rows_bitwise(torch, gen, lambda z, y, m: K.el2n(z, y, m), (z, y, m), got, what)
        nbytes = B * c * z.element_size() + B * 8 + B * 4 + B * 4
        rec = _measure(torch, {"kernel": "el2n", "entry": "el2n", "dtype": dname,
                               "logits": [B, c], "labels": "int64",
                               "layers_per_batch": 1 if c == 10 else 0,
                               "max_abs_err": float(err.max()), "max_rel_err": rel},
                       lambda: K.el2n(z, y, m), lambda: K.el2n_plain(z, y, m),
                       5.0 * B * c, nbytes, "float32")
        details.append(rec)
        CALL_CHECKS.append((rec, what, "el2n_kernel", lambda z=z, y=y, m=m: K.el2n(z, y, m)))
        print(f"  {what} (int64 labels): abs_err={rec['max_abs_err']:.3e} "
              f"ms={rec['ms']:.4f} device_ms={rec['device_ms']:.4f} "
              f"plain_ms={rec['plain_ms']:.4f} bound_ms={rec['bound_ms']:.5f} "
              f"({rec['bound_by']})", flush=True)
        check(rel <= 1e-5 or float(err.max()) <= 1e-6, f"{what}: max rel err {rel:.3e}")


def _measure(torch, rec: dict, run, plain, flops: float, nbytes: float,
             peak: str) -> dict:
    """Fill ``rec`` with the kernel's one-call and device (run of launches)
    times, the plain version's time and the bound of ``flops`` at the
    ``peak`` type's rate and ``nbytes``."""
    bnd, by = bound_ms(flops, nbytes, peak)
    rec.update(ms=time_ms(torch, run), device_ms=device_ms(torch, run),
               plain_ms=time_ms(torch, plain, warmup=1, iters=3),
               bound_ms=bnd, bound_by=by, input_bytes=float(nbytes),
               l2_warm=bool(nbytes <= L2_BYTES))
    return rec


def _rel_err(got, ref) -> tuple[float, float]:
    err = (got.float() - ref.float()).abs()
    return float(err.max()), float((err / ref.float().abs().clamp_min(1e-30)).max())


def route_kernel_phase(torch, K, dtype, rtol, details) -> None:
    """The route kernels against their plain versions at the path's shapes."""
    dname = str(dtype).replace("torch.", "")
    item = torch.tensor([], dtype=dtype).element_size()
    gen = torch.Generator(device="cuda").manual_seed(4321)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    # Last-layer GraNd: features in the working type and int64 labels, read as they are;
    # ResNet-18's head and a wide one (a ResNet-50's, 1,000 classes). Bound: the
    # product's FLOPs at the tensor-core rate (both modes run there; the split's extra
    # products not counted), beside the old fp32 CUDA-core figure.
    for f, c, layers in ((512, 10, 1), (2048, 1000, 0)):
        h = randn(B, f)
        w = torch.randn((c, f), generator=gen, device="cuda") * f ** -0.5
        bias = 0.1 * torch.randn(c, generator=gen, device="cuda")
        y = torch.randint(0, c, (B,), generator=gen, device="cuda")
        m = (torch.rand(B, generator=gen, device="cuda") > 0.1).float()
        what = f"grand_last_layer {dname} [{B},{f}]->{c}"
        got, ref = K.grand_last_layer(h, w, bias, y, m), K.grand_last_layer_plain(h, w, bias, y, m)
        torch.cuda.synchronize()
        abs_err, rel = _rel_err(got, ref)
        check_rows_bitwise(torch, gen, lambda h, y, m: K.grand_last_layer(h, w, bias, y, m),
                           (h, y, m), got, what)
        flops = 2.0 * B * f * c + 2.0 * B * f + 6.0 * B * c
        nbytes = B * f * item + 4.0 * (c * f + c) + B * (8 + 4 + 4)
        rec = _measure(torch, {"kernel": "grand_last_layer", "entry": "gll", "dtype": dname,
                               "features": [B, f], "classes": c, "labels": "int64",
                               "layers_per_batch": layers, "max_abs_err": abs_err,
                               "max_rel_err": rel, "plan": K.gll_plan(f, c, dtype),
                               "bound_fp32_cores_ms": bound_ms(flops, nbytes, "float32")[0]},
                       lambda: K.grand_last_layer(h, w, bias, y, m),
                       lambda: K.grand_last_layer_plain(h, w, bias, y, m),
                       flops, nbytes, "bfloat16")
        if c == 1000:
            # Yardstick, not a library counterpart: the classifier product alone, fp32
            # (cuBLAS, TF32 off), on fp32 features made outside the call.
            h32 = h.float()
            rec["linear_ms"] = time_ms(torch, lambda: torch.nn.functional.linear(h32, w, bias))
            rec["linear_device_ms"] = device_ms(
                torch, lambda: torch.nn.functional.linear(h32, w, bias))
        details.append(rec)
        print(f"  {what}: rel_err={rel:.3e} "
              f"ms={rec['ms']:.4f} device_ms={rec['device_ms']:.4f} "
              f"plain_ms={rec['plain_ms']:.4f} "
              f"bound_ms={rec['bound_ms']:.5f} ({rec['bound_by']}; fp32 CUDA cores "
              f"{rec['bound_fp32_cores_ms']:.4f})"
              + (f" F.linear fp32 ms={rec['linear_ms']:.4f} device_ms="
                 f"{rec['linear_device_ms']:.4f}" if "linear_ms" in rec else ""),
              flush=True)
        check(bool(torch.isfinite(got).all()) and rel <= rtol,
              f"{what}: max rel err {rel:.3e} > {rtol}")
        CALL_CHECKS.append((rec, what, "gll_kernel",
                            lambda h=h, w=w, bias=bias, y=y, m=m:
                            K.grand_last_layer(h, w, bias, y, m)))
    # Stacked BatchNorm: every ResNet-18 BN shape, one layer (5 launches per batch on
    # the BN_KERNEL route) and 5 deep (1 launch per batch with GROUP_BN), then the
    # ragged rows (BN_RAGGED).
    rows = [(shape, depth, True, True, 5 if depth == 1 else 0)
            for shape in BN_SHAPES for depth in (1, 5)]
    rows += [(shape, depth, scale, bias, 0) for shape, depth, scale, bias in BN_RAGGED]
    for shape, depth, scale, bias, layers in rows:
        c = shape[-1]
        xs = [randn(*shape) for _ in range(depth)]
        gs = [randn(*shape) for _ in range(depth)]
        stats = torch.stack([torch.randn((depth, c), generator=gen, device="cuda"),
                             torch.rand((depth, c), generator=gen, device="cuda") + 0.5],
                            dim=1)

        def call(xs, gs, stats=stats, scale=scale, bias=bias):
            return K.bn_grad_norm_sq(xs, gs, stats, scale, bias)
        what = f"bn_grad_norm {dname} x{list(shape)} x{depth} scale={scale} bias={bias}"
        mode = K.bn_mode(xs, gs)
        if shape in BN_SHAPES:
            check(mode == "vector", f"{what}: a ResNet-18 BN launch in mode {mode}")
        modes0 = K.mode_counts()["bn_grad_norm"]
        got = call(xs, gs)
        torch.cuda.synchronize()
        check_modes(K, modes0, 1, mode, what, "bn_grad_norm")
        check_bn_bitwise(torch, gen, call, xs, gs, got, what)
        ref = K.bn_grad_norm_sq_plain(xs, gs, stats, scale, bias)
        abs_err, rel = _rel_err(got, ref)
        n = depth * float(np.prod(shape))
        rec = _measure(torch, {"kernel": "bn_grad_norm", "entry": "bn", "dtype": dname,
                               "x": list(shape), "layers": depth, "use_scale": scale,
                               "use_bias": bias, "mode": mode, "layers_per_batch": layers,
                               "max_abs_err": abs_err, "max_rel_err": rel},
                       lambda: call(xs, gs),
                       lambda: K.bn_grad_norm_sq_plain(xs, gs, stats, scale, bias),
                       3.0 * n, 2.0 * n * item + 8.0 * depth * c + 4.0 * depth * shape[0],
                       "float32")
        if rec["l2_warm"] and shape in BN_SHAPES:
            copies = [([t.clone() for t in xs], [t.clone() for t in gs])
                      for _ in range(cold_copies(rec["input_bytes"]))]
            rec["device_cold_ms"] = device_ms(torch, [lambda xc=xc, gc=gc: call(xc, gc)
                                                      for xc, gc in copies])
            del copies
        details.append(rec)
        print(f"  {what} ({mode}): rel_err={rel:.3e} ms={rec['ms']:.4f} "
              f"device_ms={rec['device_ms']:.4f}"
              + (f" (inputs {rec['input_bytes'] / 2**20:.1f} MiB fit L2; cold "
                 f"{rec['device_cold_ms']:.4f})" if "device_cold_ms" in rec else "")
              + f" plain_ms={rec['plain_ms']:.4f} "
              f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']})", flush=True)
        check(bool(torch.isfinite(got).all()) and rel <= rtol,
              f"{what}: max rel err {rel:.3e} > {rtol}")
    # Cat-dot at every CATDOT_GEOMETRIES row. Yardstick, not a library counterpart:
    # the direct kernel at the same layer (v2 where it takes the layer), which
    # computes the same function (``direct_ms``).
    for xs_, gs_, ks, pad, layers in CATDOT_GEOMETRIES:
        x, g = randn(*xs_), randn(*gs_)

        def call(x, g, ks=ks, pad=pad):
            return K.conv_grad_norm_sq_catdot(x, g, ks, pad)
        what = f"conv_grad_norm_catdot {dname} x{list(xs_)} g{list(gs_)} k{ks}"
        modes0 = K.mode_counts()["conv_grad_norm_catdot"]
        got = call(x, g)
        torch.cuda.synchronize()
        check_modes(K, modes0, 1, K.DIRECT_MODES[dtype], what, "conv_grad_norm_catdot")
        if dtype == torch.bfloat16:
            check_bitwise(torch, gen, call, x, g, got, what)
        ref = K.conv_grad_norm_sq_catdot_plain(x, g, ks, pad)
        abs_err, rel = _rel_err(got, ref)
        rec = _measure(torch, {"kernel": "conv_grad_norm_catdot", "entry": "catdot",
                               "dtype": dname, "x": list(xs_), "g": list(gs_),
                               "kernel_size": list(ks), "padding": [list(p) for p in pad],
                               "layers_per_batch": layers, "max_abs_err": abs_err,
                               "max_rel_err": rel},
                       lambda: call(x, g),
                       lambda: K.conv_grad_norm_sq_catdot_plain(x, g, ks, pad),
                       2.0 * xs_[0] * gs_[1] * gs_[2] * ks[0] * ks[1] * xs_[3] * gs_[3],
                       (np.prod(xs_) + np.prod(gs_)) * item + 4.0 * xs_[0], dname)
        if K.conv_grad_norm_v2_eligible(xs_, gs_, ks, (1, 1), pad):
            rec["direct_ms"] = time_ms(torch, lambda: K.conv_grad_norm_sq_v2(x, g, ks, pad))
        else:
            rec["direct_ms"] = time_ms(torch, lambda: K.conv_grad_norm_sq(x, g, ks, (1, 1), pad))
        details.append(rec)
        print(f"  {what}: rel_err={rel:.3e} ms={rec['ms']:.4f} "
              f"device_ms={rec['device_ms']:.4f} "
              f"plain_ms={rec['plain_ms']:.4f} bound_ms={rec['bound_ms']:.4f} "
              f"({rec['bound_by']}) direct_ms={rec['direct_ms']:.4f}", flush=True)
        check(bool(torch.isfinite(got).all()) and rel <= rtol,
              f"{what}: max rel err {rel:.3e} > {rtol}")
    # Megakernel at every MEGA_GEOMETRIES row. Yardsticks, not library counterparts:
    # a cuDNN input gradient of the same conv in the same dtype (``dgrad_ms``; at
    # symmetric padding) plus the direct kernel's norm at the same layer
    # (``direct_ms``), the two launches the megakernel replaces on its route.
    for xs_, gs_, ks, pad, bias, layers in MEGA_GEOMETRIES:
        x, g = randn(*xs_), randn(*gs_)
        w = torch.randn((gs_[3], xs_[3], *ks), generator=gen, device="cuda") * 0.05
        w = w.contiguous(memory_format=torch.channels_last)

        def call(x, g, w=w, ks=ks, pad=pad, bias=bias):
            return K.conv_bwd_grad_norm_sq(x, g, w, ks, pad, use_bias=bias)
        what = f"conv_bwd_grad_norm {dname} x{list(xs_)} g{list(gs_)} k{ks}"
        modes0 = K.mode_counts()["conv_bwd_grad_norm"]
        dx, ns = call(x, g)
        torch.cuda.synchronize()
        check_modes(K, modes0, 1, K.DIRECT_MODES[dtype], what, "conv_bwd_grad_norm")
        if dtype == torch.bfloat16:
            check_bitwise(torch, gen, call, x, g, (dx, ns), what)
            if not bias:   # the norm role is the direct kernel's walk, to the bit
                check(torch.equal(ns, K.conv_grad_norm_sq(x, g, ks, (1, 1), pad)),
                      f"{what}: norm not bitwise equal to the direct kernel's")
        rdx, rns = K.conv_bwd_grad_norm_sq_plain(x, g, w, ks, pad, use_bias=bias)
        abs_err, rel = _rel_err(ns, rns)
        dx_err = (dx.float() - rdx.float()).abs()
        scale = float(rdx.float().abs().max())
        dx_excess = float((dx_err - MEGA_DX_TOL[dname] * rdx.float().abs()).max())
        flops = 2.0 * 2.0 * xs_[0] * gs_[1] * gs_[2] * ks[0] * ks[1] * xs_[3] * gs_[3]
        nbytes = (2 * np.prod(xs_) + np.prod(gs_)) * item + 4.0 * w.numel() + 4.0 * xs_[0]
        rec = _measure(torch, {"kernel": "conv_bwd_grad_norm", "entry": "mega",
                               "dtype": dname, "x": list(xs_), "g": list(gs_),
                               "kernel_size": list(ks), "padding": [list(p) for p in pad],
                               "use_bias": bias, "layers_per_batch": layers,
                               "max_abs_err": max(abs_err, float(dx_err.max())),
                               "max_rel_err": rel, "dx_max_abs_err": float(dx_err.max()),
                               "dx_scale": scale},
                       lambda: call(x, g),
                       lambda: K.conv_bwd_grad_norm_sq_plain(x, g, w, ks, pad, use_bias=bias),
                       flops, nbytes, dname)
        rec["direct_ms"] = time_ms(torch, lambda: K.conv_grad_norm_sq(x, g, ks, (1, 1), pad))
        rec["dgrad_ms"] = None
        if pad[0][0] == pad[0][1] and pad[1][0] == pad[1][1]:
            wd, gn = w.to(dtype), g.permute(0, 3, 1, 2)
            size = (xs_[0], xs_[3], xs_[1], xs_[2])
            rec["dgrad_ms"] = time_ms(torch, lambda: torch.nn.grad.conv2d_input(
                size, wd, gn, padding=(pad[0][0], pad[1][0])))
        details.append(rec)
        yard = ("" if rec["dgrad_ms"] is None else
                f" dgrad_ms={rec['dgrad_ms']:.4f} + direct_ms={rec['direct_ms']:.4f}")
        print(f"  {what}: norm rel_err={rel:.3e} "
              f"dx max abs err={float(dx_err.max()):.3e} (max |dx| {scale:.3e}) "
              f"ms={rec['ms']:.4f} device_ms={rec['device_ms']:.4f} "
              f"plain_ms={rec['plain_ms']:.4f} "
              f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']}){yard}", flush=True)
        check(dx.dtype == dtype and bool(torch.isfinite(dx).all())
              and bool(torch.isfinite(ns).all()), f"{what}: output")
        check(rel <= rtol, f"{what}: norm rel err {rel:.3e}")
        check(dx_excess <= 1e-5 * scale, f"{what}: dx beyond rtol {MEGA_DX_TOL[dname]}")


# Classifier scale of the parity weights: with the BatchNorms randomized the
# features grow through the blocks and the unscaled classifier gives logits
# spread over ~50-100 per row; the saturated softmax then moves fp32 scores by
# ~2e-4 from float64 (and by batch geometry). At 0.05 the logits' std is ~1
# and fp32 stays within ~4e-6 of float64.
PARITY_CLASSIFIER_SCALE = 0.05


def bn_randomized(torch, port, seed: int, device: str = "cuda") -> dict:
    """ResNet-18 variables on ``device`` with every BatchNorm randomized (at
    init the closing BN scale is zero, which would zero half the convs'
    cotangents) and the classifier scaled by ``PARITY_CLASSIFIER_SCALE``."""
    v = port["init_variables"]("resnet18", seed, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, t in v.items():
        if t.dim() == 1 and not name.startswith("classifier"):
            if name.endswith("running_var"):
                v[name] = torch.rand(t.shape, generator=gen, device=device) + 0.5
            else:
                base = 1.0 if name.endswith(".weight") else 0.0
                v[name] = base + 0.3 * torch.randn(t.shape, generator=gen, device=device)
        elif name.startswith("classifier"):
            v[name] = PARITY_CLASSIFIER_SCALE * t
    return v


@contextlib.contextmanager
def toggles(gb, flags: dict):
    """Set ``DDT_GRAND_*`` module attributes of the port for a block."""
    old = {k: getattr(gb, k) for k in flags}
    for k, v in flags.items():
        setattr(gb, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(gb, k, v)


def path_phase(torch, port, details_out, card: str) -> dict:
    cfg = port["load_config"](os.path.join(REPO, "configs", "cifar10_resnet18.yaml"), [
        "data.dataset=synthetic", f"data.synthetic_size={N_PATH}",
        "score.pretrain_epochs=0", f"score.seeds={list(SEEDS)}",
        f"score.batch_size={B}", "train.half_precision=true"])
    ds, _ = port["load_dataset"]("synthetic", synthetic_size=N_PATH, seed=0)
    model = port["create_model_from_cfg"](cfg)
    variables = [port["init_variables"]("resnet18", s, "cuda") for s in SEEDS]
    nb = -(-N_PATH // B)
    K = port["kernels"]
    # Warm-up on one batch (cuDNN heuristics, library load) before the counted run.
    warm = ds.subset(ds.indices[:B])
    for method in ("el2n", "grand"):
        port["score_dataset"](model, variables[:1], warm, method=method, batch_size=B,
                              device="cuda")
    K.reset_launch_counts()
    results = {}
    before = K.launch_counts()
    for method in ("el2n", "grand"):
        modes0 = K.mode_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = port["score_dataset"](model, variables, ds, method=method,
                                       batch_size=B, device="cuda")
        wall = time.perf_counter() - t0
        after = K.launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        before = after
        for kern in ("conv_grad_norm_direct", "conv_grad_norm_gram"):
            check_modes(K, modes0[kern], delta[kern], "tensor_core", method, kern)
        check(scores.shape == (N_PATH,), f"{method}: scores shape {scores.shape}")
        check(bool(np.isfinite(scores).all()), f"{method}: non-finite scores")
        check(bool((scores >= 0).all()), f"{method}: negative scores")
        want = dict.fromkeys(K.KERNELS, 0)
        if method == "el2n":
            check(bool((scores <= np.sqrt(2) + 1e-6).all()), "el2n above sqrt(2)")
            want["el2n"] = nb * len(SEEDS)
        else:
            want.update(conv_grad_norm_direct=12 * nb * len(SEEDS),
                        conv_grad_norm_gram=3 * nb * len(SEEDS))
        check(delta == want, f"{method}: launch counts {delta}, want {want}")
        ex_s = N_PATH * len(SEEDS) / wall
        results[method] = {"scores": scores, "wall_s": wall, "ex_per_s": ex_s,
                           "launches": delta}
        print(f"  {method}: {N_PATH} examples x {len(SEEDS)} seeds in {wall:.3f} s = "
              f"{ex_s:.1f} ex/s on {card}; launches {delta}; "
              f"mean score {scores.mean():.5f}", flush=True)
    counts = K.launch_counts()
    details_out["path"] = {m: {k: v for k, v in r.items() if k != "scores"}
                           for m, r in results.items()}

    # Kernel route vs plain route end to end: fp32, TF32 off, BN randomized.
    port["set_parity_mode"](True)
    cfg32 = port["load_config"](None, ["data.dataset=synthetic", "model.arch=resnet18",
                                       "train.half_precision=false"])
    model32 = port["create_model_from_cfg"](cfg32)
    v = bn_randomized(torch, port, 7)
    sub = ds.subset(ds.indices[:2 * B])
    for method in ("grand", "el2n"):
        modes0 = K.mode_counts()
        fast = port["score_dataset"](model32, [v], sub, method=method, batch_size=B,
                                     use_kernels=True, device="cuda")
        for kern, per_batch in (("conv_grad_norm_direct", 12), ("conv_grad_norm_gram", 3)):
            check_modes(K, modes0[kern], per_batch * 2 if method == "grand" else 0, "fp32",
                        f"{method} fp32", kern)
        plain = port["score_dataset"](model32, [v], sub, method=method, batch_size=B,
                                      use_kernels=False, device="cuda")
        rel = float(np.max(np.abs(fast - plain) / np.maximum(np.abs(plain), 1e-30)))
        print(f"  {method} fp32 kernel route vs plain route ({2 * B} examples, "
              f"BN randomized): max rel err {rel:.3e}", flush=True)
        details_out.setdefault("route_parity", {})[method] = rel
        check(rel <= 1e-4, f"{method}: kernel route vs plain route rel err {rel:.3e}")
    port["set_parity_mode"](False)
    return {"cfg": cfg, "ds": ds, "variables": variables, "results": results,
            "counts": counts}


def calls_phase(torch) -> None:
    """Each EL2N and last-layer row's call, on its kernel-phase inputs, runs one
    CUDA kernel, its own, and no copy, cast or memset (``kernels_per_call``)."""
    for rec, what, kernel, call in CALL_CHECKS:
        launched = kernels_per_call(torch, call)
        rec["kernels_per_call"] = launched
        print(f"  {what}: CUDA kernels per call {launched}", flush=True)
        check(len(launched) == 1 and kernel in launched[0],
              f"{what}: one call ran {launched}, want {kernel} alone")
    CALL_CHECKS.clear()


# ResNet-50 head pass: CIFAR-100 geometry (32x32x3, 100 classes), 1,024 examples.
R50_N = 1024
R50_CLASSES = 100
R50_REPEATS = 3   # timed passes per method (the launch counts are read after each)


def r50_dataset(port, n: int):
    """Synthetic CIFAR-100-geometry data (CIFAR-100 itself is not in the repo): a
    fixed template per class plus noise, drawn from seed 0."""
    rng = np.random.default_rng(0)
    templates = rng.normal(0.0, 0.5, size=(R50_CLASSES, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, R50_CLASSES, size=n).astype(np.int32)
    images = templates[labels] + rng.normal(0.0, 0.4, size=(n, 32, 32, 3)).astype(np.float32)
    return port["ArrayDataset"](images=images, labels=labels,
                                indices=np.arange(n, dtype=np.int32), num_classes=R50_CLASSES)


def resnet50_phase(torch, port, details_out, card: str) -> dict:
    """A ResNet-50 head ([512, 2048] -> 100) through both redesigned kernels on a
    real scoring path: ``score_dataset`` with ``el2n`` and ``grand_last_layer``
    at full width, bf16, batch 512, one seed (one launch a batch, finite
    scores, ex/s of each of ``R50_REPEATS`` passes, the first counted in the
    kernels line); then in fp32 parity mode (TF32 off) each against the plain
    route."""
    K = port["kernels"]
    ds = r50_dataset(port, R50_N)
    model = port["create_model"]("resnet50", R50_CLASSES, half_precision=True)
    v = [port["init_variables"]("resnet50", 0, "cuda", num_classes=R50_CLASSES)]
    nb = -(-R50_N // B)
    warm = ds.subset(ds.indices[:B])
    out, counts = {}, dict.fromkeys(K.KERNELS, 0)
    for method in ("el2n", "grand_last_layer"):
        port["score_dataset"](model, v, warm, method=method, batch_size=B, device="cuda")
        walls = []
        for rep in range(R50_REPEATS):
            K.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scores = port["score_dataset"](model, v, ds, method=method, batch_size=B,
                                           device="cuda")
            walls.append(time.perf_counter() - t0)
            got = K.launch_counts()
            want = {k: (nb if k == method else 0) for k in K.KERNELS}
            check(got == want, f"resnet50 {method}: launch counts {got}, want {want}")
            if rep == 0:
                for k, n in got.items():
                    counts[k] += n
        check(scores.shape == (R50_N,) and bool(np.isfinite(scores).all())
              and bool((scores >= 0).all()), f"resnet50 {method}: scores not finite/>= 0")
        ex_s = [R50_N / wall for wall in walls]
        out[method] = {"wall_s": walls, "ex_per_s": ex_s, "launches": nb}
        print(f"  resnet50 {method}: {R50_N} examples x 1 seed, {R50_REPEATS} passes: "
              + ", ".join(f"{x:.1f}" for x in ex_s) + f" ex/s on {card}; {nb} launches a "
              f"pass ({nb} batches); mean score {scores.mean():.5f}", flush=True)
    port["set_parity_mode"](True)
    model32 = port["create_model"]("resnet50", R50_CLASSES)
    for method in ("el2n", "grand_last_layer"):
        fast = port["score_dataset"](model32, v, ds, method=method, batch_size=B,
                                     use_kernels=True, device="cuda")
        plain = port["score_dataset"](model32, v, ds, method=method, batch_size=B,
                                      use_kernels=False, device="cuda")
        err = np.abs(fast - plain)
        rel = float(np.max(err / np.maximum(np.abs(plain), 1e-30)))
        ok = (rel <= 1e-4 if method == "grand_last_layer"
              else bool(np.all((err <= 1e-5 * np.abs(plain)) | (err <= 1e-6))))
        out[method]["fp32_rel_err_vs_plain_route"] = rel
        print(f"  resnet50 {method} fp32 kernel route vs plain route ({R50_N} examples): "
              f"max rel err {rel:.3e}, max abs err {float(err.max()):.3e}", flush=True)
        check(ok, f"resnet50 {method}: kernel route vs plain route rel err {rel:.3e}")
    port["set_parity_mode"](False)
    details_out["resnet50"] = out
    return {"counts": counts}


# Train phase: full-width ResNet-18, bf16, batch 128, synthetic CIFAR-10-geometry data.
TRAIN_N = 8192
TRAIN_B = 128
# The fit's final test accuracy must beat chance (1/10) by this much. The same recipe
# on the CPU in fp32 at 1,024 examples (2 epochs, 16 steps: ``cli train --device cpu``
# with these overrides and train.half_precision=false) reached 0.707.
TRAIN_ACC_MARGIN = 0.3
REPRO_N = 2560          # 20 steps of TRAIN_B
RESUME_N = 1024         # 8 steps an epoch
PARITY_N = 80           # batches of 32, 32 and a padded tail of 16
PARITY_B = 32
TIMED_STEPS = 20
# Checkpoints of the train phase (a ResNet-18 step is ~135 MB): in the ignored
# chip_smoke_out/ of the checkout, never in --out, and removed after the phase.
TRAIN_CKPT_DIR = os.path.join(REPO, "chip_smoke_out", "train_ckpt")


def train_cfg(port, *over):
    """The BASELINE ResNet-18 recipe (``configs/cifar10_resnet18.yaml``: lr 0.01,
    momentum 0.9, weight decay 5e-4, bf16) on synthetic CIFAR-10-geometry data."""
    return port["load_config"](os.path.join(REPO, "configs", "cifar10_resnet18.yaml"), [
        "data.dataset=synthetic", f"data.synthetic_size={TRAIN_N}",
        f"data.batch_size={TRAIN_B}", "score.pretrain_epochs=0", *over])


def north_star_cfg(port, checkpoint_dir: str, n: int = TRAIN_N, *over):
    """The north-star ``configs/cifar10_resnet18_grand10.yaml`` at ``n`` synthetic
    examples, seeds [0, 1] and 2 retrain epochs."""
    return port["load_config"](
        os.path.join(REPO, "configs", "cifar10_resnet18_grand10.yaml"),
        ["data.dataset=synthetic", f"data.synthetic_size={n}", "score.seeds=[0,1]",
         "train.num_epochs=2", f"train.checkpoint_dir={checkpoint_dir}", *over])


def ckpt_arrays(directory: str, step: int | None = None) -> tuple[int, dict]:
    """A checkpoint step's arrays as saved (the newest step by default)."""
    if step is None:
        step = max(int(n[len("step_"):]) for n in os.listdir(directory)
                   if n.startswith("step_") and n[len("step_"):].isdigit())
    with np.load(os.path.join(directory, f"step_{step}", "arrays.npz")) as f:
        return step, {k: f[k] for k in f.files}


def arrays_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def state_equal(torch, a, b) -> bool:
    return a.step == b.step and all(
        torch.equal(getattr(a, g)[k], getattr(b, g)[k])
        for g in ("params", "batch_stats", "momentum") for k in getattr(a, g))


def step_ms(torch, port, cfg, ds, deterministic: bool) -> float:
    """Host wall per train step over ``TIMED_STEPS`` steps (after 3 warm-up
    steps), ending in a synchronize, with cuDNN's deterministic algorithms or
    with its autotuned ones; the determinism switches are restored after."""
    T = port["train"]
    model = port["create_model_from_cfg"](cfg).to("cuda")
    state = T["create_train_state"](cfg, 0, "cuda", model)
    sgd = T["make_optimizer"](cfg, 64)
    batches = list(T["ResidentBatches"](ds, TRAIN_B, "cuda", torch.bfloat16)())
    torch.backends.cudnn.deterministic = deterministic
    torch.backends.cudnn.benchmark = not deterministic
    try:
        for b in batches[:3]:
            T["train_step"](model, sgd, state, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(TIMED_STEPS):
            T["train_step"](model, sgd, state, batches[i % len(batches)])
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / TIMED_STEPS
    finally:
        port["set_scoring_determinism"]()


def train_phase(torch, port, details_out, card: str) -> dict:
    """Training on the card: a fit, its reproducibility and resume, the card
    against the CPU, the north-star ``run`` (its scoring launches counted),
    and every kernel route against its plain route on pretrained weights.
    Checkpoints go to ``TRAIN_CKPT_DIR`` and are removed after."""
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        return _train_phase(torch, port, details_out, card)
    finally:
        shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
        print(f"  train phase: {time.perf_counter() - t0:.1f} s", flush=True)


def _train_phase(torch, port, details_out, card: str) -> dict:
    T = port["train"]
    K = port["kernels"]
    rec: dict = {}
    cfg = train_cfg(port, "train.num_epochs=2")
    train_ds, test_ds = T["load_data_for"](cfg)
    steps_per_epoch = -(-TRAIN_N // TRAIN_B)

    # 1. Fit: 2 epochs with eval; epoch 1 is the steady one.
    res = T["fit"](cfg, train_ds, test_ds, device="cuda")
    hist = res.history
    for h in hist:
        print(f"  fit epoch {h['epoch']}: {h['examples_per_s']:.1f} ex/s "
              f"({h['epoch_s']:.3f} s), train loss {h['train_loss']:.4f}, "
              f"test accuracy {h['test_accuracy']:.4f} on {card}", flush=True)
    steady_step_ms = 1e3 * hist[1]["epoch_s"] / steps_per_epoch
    model = port["create_model_from_cfg"](cfg).to("cuda")
    resident = T["maybe_resident"](test_ds, cfg.data.eval_batch_size, "cuda",
                                   torch.bfloat16, enabled=True)
    T["evaluate"](model, res.state, test_ds, cfg.data.eval_batch_size, device="cuda",
                  resident=resident)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev = T["evaluate"](model, res.state, test_ds, cfg.data.eval_batch_size,
                       device="cuda", resident=resident)
    eval_s = time.perf_counter() - t0
    eval_rate = len(test_ds) / eval_s
    print(f"  steady train step {steady_step_ms:.3f} ms (batch {TRAIN_B}, bf16); eval "
          f"{eval_rate:.1f} ex/s ({len(test_ds)} examples, batch "
          f"{cfg.data.eval_batch_size})", flush=True)
    check(hist[1]["train_loss"] < hist[0]["train_loss"],
          f"train loss did not fall: {[h['train_loss'] for h in hist]}")
    check(hist[-1]["test_accuracy"] > 0.1 + TRAIN_ACC_MARGIN,
          f"test accuracy {hist[-1]['test_accuracy']} not above chance + "
          f"{TRAIN_ACC_MARGIN}")
    check(ev["accuracy"] == hist[-1]["test_accuracy"], "evaluate disagrees with fit")
    rec["fit"] = {"history": hist, "steady_step_ms": steady_step_ms,
                  "eval_examples_per_s": eval_rate}

    # 2. Reproducibility: two fits of 20 steps from one seed, bitwise; and what
    # the deterministic cuDNN algorithms cost (deterministic, autotuned, autotuned,
    # deterministic).
    small = train_ds.subset(train_ds.indices[:REPRO_N])
    runs = [T["fit"](cfg, small, None, device="cuda", num_epochs=1, seed=3)
            for _ in range(2)]
    check(state_equal(torch, runs[0].state, runs[1].state),
          "two fits from one seed differ on the card")
    det = {True: [], False: []}
    for flag in (True, False, False, True):
        det[flag].append(step_ms(torch, port, cfg, small, flag))
    print(f"  reproducible: two 20-step fits from one seed bitwise equal; train step "
          f"{statistics.median(det[True]):.3f} ms with deterministic cuDNN "
          f"({det[True]}), {statistics.median(det[False]):.3f} ms autotuned "
          f"({det[False]})", flush=True)
    rec["step_ms_deterministic"] = det[True]
    rec["step_ms_autotuned"] = det[False]

    # 3. Resume: fit(2) == fit(1) + resume(1), through the port's checkpoint.
    rcfg = train_cfg(port, "train.num_epochs=2", "optim.cosine_t_max_epochs=2",
                     "data.augment=true")
    rds = train_ds.subset(train_ds.indices[:RESUME_N])
    whole = T["fit"](rcfg, rds, None, device="cuda")
    ckpt = os.path.join(TRAIN_CKPT_DIR, "resume")
    T["fit"](rcfg, rds, None, device="cuda", num_epochs=1, checkpoint_dir=ckpt)
    rcfg.train.resume = True
    rest = T["fit"](rcfg, rds, None, device="cuda", checkpoint_dir=ckpt)
    check([h["epoch"] for h in rest.history] == [1], "resume did not start at epoch 1")
    check(state_equal(torch, rest.state, whole.state),
          "fit(1) + resume(1) differs from fit(2) on the card")
    print(f"  resume: fit(2) == fit(1) + resume(1) bitwise ({RESUME_N} examples, "
          "augmented)", flush=True)

    # 4. The card against the CPU: 3 fp32 train steps, TF32 off, one padded tail;
    # and the CPU in float64, which measures fp32's own error on this net.
    port["set_parity_mode"](True)
    pcfg = train_cfg(port, "train.half_precision=false", "train.num_epochs=1",
                     f"data.batch_size={PARITY_B}")
    pds = train_ds.subset(train_ds.indices[:PARITY_N])
    v = bn_randomized(torch, port, 11, "cpu")
    results = {}
    for label, dev, dtype in (("cuda", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
                              ("f64", "cpu", torch.float64)):
        model = port["create_model_from_cfg"](pcfg).to(dev, dtype)
        model.dtype = dtype
        state = T["state_from_variables"](
            {k: t.to(dtype) for k, t in port["variables_to"](v, dev).items()}, model)
        sgd = T["make_optimizer"](pcfg, 3)
        losses = []
        for b in T["iterate_batches"](pds, PARITY_B):
            b = {k: (t.to(dtype) if t.is_floating_point() else t)
                 for k, t in T["to_device"](b, dev).items()}
            losses.append(float(T["train_step"](model, sgd, state, b)["loss"]))
        results[label] = (losses, {k: t.cpu().double() for k, t in state.variables.items()})
    port["set_parity_mode"](False)
    (l_gpu, v_gpu), (l_cpu, v_cpu), (_, v_64) = (results[k] for k in ("cuda", "cpu", "f64"))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
    # fp32's own error here: the CPU fp32 run's largest distance from float64.
    eps_cpu = max(float((v_cpu[k] - v_64[k]).abs().max()) for k in v_64)
    eps_gpu = max(float((v_gpu[k] - v_64[k]).abs().max()) for k in v_64)
    atol = max(1e-6, 2 * eps_cpu)
    var_err, worst = max((float(((v_gpu[k] - v_cpu[k]).abs() - 1e-4 * v_cpu[k].abs()).max()),
                          k) for k in v_cpu)
    print(f"  card vs CPU, 3 fp32 steps (TF32 off, tail of {PARITY_N % PARITY_B}): losses "
          f"{l_gpu} vs {l_cpu}, max rel {loss_rel:.3e}; variables: max |d| - 1e-4|cpu| "
          f"{var_err:.3e} ({worst}); from float64: card {eps_gpu:.3e}, CPU {eps_cpu:.3e}",
          flush=True)
    check(loss_rel <= 1e-5, f"card vs CPU loss rel err {loss_rel:.3e}")
    check(var_err <= atol, f"card vs CPU variables beyond rtol 1e-4 / atol {atol:.3e} "
                           f"({var_err:.3e}, {worst})")
    check(eps_gpu <= atol, f"card fp32 {eps_gpu:.3e} from float64, CPU fp32 {eps_cpu:.3e}")
    rec["card_vs_cpu"] = {"loss_rel": loss_rel, "var_excess": var_err, "worst": worst,
                          "card_from_f64": eps_gpu, "cpu_from_f64": eps_cpu}

    # 5. The north-star run at 8,192 examples, 2 seeds, 2 epochs of retrain.
    run_cfg = north_star_cfg(port, os.path.join(TRAIN_CKPT_DIR, "run"))
    nb = -(-TRAIN_N // run_cfg.score.batch_size)
    K.reset_launch_counts()
    modes0 = K.mode_counts()
    t0 = time.perf_counter()
    summary = T["run_datadiet"](run_cfg, device="cuda")
    run_wall = time.perf_counter() - t0
    counts = K.launch_counts()
    want = dict.fromkeys(K.KERNELS, 0)
    want.update(conv_grad_norm_direct=12 * nb * 2, conv_grad_norm_gram=3 * nb * 2)
    check(counts == want, f"run: launch counts {counts}, want {want}")
    for kern in ("conv_grad_norm_direct", "conv_grad_norm_gram"):
        check_modes(K, modes0[kern], want[kern], "tensor_core", "run", kern)
    npz = T["scores_npz_path"](run_cfg.train.checkpoint_dir)
    with np.load(npz) as f:
        kept = f["kept"]
        check(bool(np.isfinite(f["scores"]).all()), "run: non-finite scores")
    T["verify_prune_manifest"](npz, kept)
    check(summary["n_kept"] == TRAIN_N // 2 == len(kept), f"run: n_kept {summary['n_kept']}")
    check(summary["final_test_accuracy"] is not None
          and bool(np.isfinite(summary["final_test_accuracy"])),
          f"run: final test accuracy {summary['final_test_accuracy']}")
    walls = {k: summary[k] for k in ("pretrain_wall_s", "score_wall_s", "prune_wall_s",
                                     "train_wall_s")}
    print(f"  run ({TRAIN_N} examples, seeds [0, 1], score batch "
          f"{run_cfg.score.batch_size}, grand): {run_wall:.3f} s; stages "
          + ", ".join(f"{k[:-7]} {v:.3f} s" for k, v in walls.items())
          + f"; n_kept {summary['n_kept']}, final test accuracy "
          f"{summary['final_test_accuracy']:.4f}; launches {counts} (tensor-core mode); "
          "prune manifest verified", flush=True)
    rec["run"] = {"wall_s": run_wall, **walls, "n_kept": summary["n_kept"],
                  "final_test_accuracy": summary["final_test_accuracy"],
                  "launches": counts}
    # What the resilience phase's drills must reproduce bitwise.
    with np.load(npz) as f:
        run_art = {"scores": f["scores"], "kept": f["kept"], "walls": walls,
                   "arrays": ckpt_arrays(run_cfg.train.checkpoint_dir)[1]}

    # 6. Each kernel route against the plain route on the pretrained seed-0
    # variables, fp32, TF32 off: rtol 1e-4 (atol 1e-6 for EL2N, whose scores of
    # well-fit examples sit near 0).
    pretrained = T["score_variables_for_seeds"](run_cfg, train_ds, device="cuda",
                                                seeds=[0])
    port["set_parity_mode"](True)
    model32 = port["create_model"]("resnet18", 10)
    sub = train_ds.subset(train_ds.indices[:2 * B])
    rec["trained_parity"] = {}
    for method, eval_mode, atol in (("el2n", True, 1e-6), ("grand", True, 0.0),
                                    ("grand_last_layer", True, 0.0),
                                    ("el2n", False, 1e-6)):
        kw = dict(method=method, batch_size=B, eval_mode=eval_mode, device="cuda")
        fast = port["score_dataset"](model32, pretrained, sub, use_kernels=True, **kw)
        plain = port["score_dataset"](model32, pretrained, sub, use_kernels=False, **kw)
        err = np.abs(fast - plain)
        rel = float(np.max(err / np.maximum(np.abs(plain), 1e-30)))
        what = f"{method} ({'eval' if eval_mode else 'train'} mode)"
        print(f"  trained weights, {what}: kernel route vs plain route max rel err "
              f"{rel:.3e}, max abs err {float(err.max()):.3e}", flush=True)
        check(bool(np.all(err <= 1e-4 * np.abs(plain) + atol)),
              f"trained weights, {what}: kernel route vs plain route rel err {rel:.3e}")
        rec["trained_parity"][what] = {"max_rel": rel, "max_abs": float(err.max())}
    port["set_parity_mode"](False)
    details_out["train"] = rec
    return {"counts": counts, "run": run_art}


# Resilience phase: the north-star run preempted, resumed and corrupted on the card.
RES_DIR = os.path.join(REPO, "chip_smoke_out", "resilience_ckpt")
HANG_TIMEOUT_S = 10      # resilience.step_timeout_s of drill E
HANG_WALL_S = 60         # drill E's whole fit_with_recovery must end within this
G_N = 2048               # drill G's examples (two CLI processes)
OVERHEAD_PAIRS = 3


class Events:
    """A ``log(kind, **fields)`` callable that keeps every record."""

    def __init__(self):
        self.records: list[dict] = []

    def __call__(self, kind, **fields):
        self.records.append({"kind": kind, **fields})

    def of(self, kind: str) -> list[dict]:
        return [e for e in self.records if e["kind"] == kind]


def expect_preempted(port, fn):
    """``fn()`` must raise ``Preempted``; returns it."""
    try:
        fn()
    except port["Preempted"] as p:
        return p
    fail(f"{fn}: no Preempted raised")


def with_plan(port, plan: dict, fn):
    inject = port["inject"]
    inject.activate(inject.plan_from_dict(plan))
    try:
        return fn()
    finally:
        inject.deactivate()


def counted(K, fn):
    """``fn()`` with the launch counts set to 0 just before and read just after:
    (result, counts, mode counts before)."""
    K.reset_launch_counts()
    modes0 = K.mode_counts()
    out = fn()
    return out, K.launch_counts(), modes0


def resilience_phase(torch, port, details_out, trained: dict) -> dict:
    """The resilience core on the card (drills A-G and the hooks' overhead).
    Checkpoints go to ``RES_DIR`` and are removed after."""
    shutil.rmtree(RES_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        return _resilience_phase(torch, port, details_out, trained)
    finally:
        shutil.rmtree(RES_DIR, ignore_errors=True)
        wall = time.perf_counter() - t0
        details_out.setdefault("resilience", {})["phase_wall_s"] = wall
        print(f"  resilience phase: {wall:.1f} s", flush=True)


def _resilience_phase(torch, port, details_out, trained: dict) -> dict:
    T, K = port["train"], port["kernels"]
    rec: dict = {}
    details_out["resilience"] = rec
    total = dict.fromkeys(K.KERNELS, 0)

    def add(counts):
        for k in total:
            total[k] += counts[k]

    # A. Preempt mid-scoring (after seed 0's partial), then re-invoke: only seed
    # 1 is pretrained and scored, and everything equals the train phase's run.
    dir_a = os.path.join(RES_DIR, "a")
    cfg = north_star_cfg(port, dir_a)
    nb = -(-TRAIN_N // cfg.score.batch_size)
    one_seed = dict.fromkeys(K.KERNELS, 0)
    one_seed.update(conv_grad_norm_direct=12 * nb, conv_grad_norm_gram=3 * nb)
    p, counts, modes0 = counted(K, lambda: with_plan(
        port, {"sigterm_after_seed_scores": 1},
        lambda: expect_preempted(port, lambda: T["run_datadiet"](cfg, device="cuda"))))
    add(counts)
    check(counts == one_seed, f"A, preempted pass: launches {counts}, want {one_seed}")
    parts = sorted(os.listdir(f"{dir_a}_score_partials"))
    manifest = port["StageManifest"](f"{dir_a}_stages.json",
                                     T["pipeline_fingerprint"](cfg))
    check(parts == ["seed0.npz"] and not manifest.completed("score"),
          f"A: partials {parts}, score stage {manifest.status('score')}")
    ev = Events()
    t1 = time.perf_counter()
    summary, counts, modes0 = counted(K, lambda: T["run_datadiet"](
        north_star_cfg(port, dir_a), device="cuda", log=ev))
    wall = time.perf_counter() - t1
    add(counts)
    check(counts == one_seed, f"A, resumed pass: launches {counts}, want {one_seed}")
    for kern in ("conv_grad_norm_direct", "conv_grad_norm_gram"):
        check_modes(K, modes0[kern], one_seed[kern], "tensor_core", "A, resumed", kern)
    resumed = [(e["done"], e["todo"]) for e in ev.of("score_seeds_resumed")]
    check(resumed == [([0], [1])], f"A: score_seeds_resumed {resumed}")
    with np.load(T["scores_npz_path"](dir_a)) as f:
        scores_a, kept_a = f["scores"], f["kept"]
    arrays_a = ckpt_arrays(dir_a)[1]
    run = trained["run"]
    check(np.array_equal(scores_a, run["scores"]), "A: scores differ from the train "
          f"phase's run (max |d| {float(np.abs(scores_a - run['scores']).max()):.3e})")
    check(np.array_equal(kept_a, run["kept"]), "A: kept set differs")
    check(arrays_equal(arrays_a, run["arrays"]), "A: final retrain arrays differ")
    rec["A"] = {"resumed_wall_s": wall, "pretrain_wall_s": summary["pretrain_wall_s"],
                "score_wall_s": summary["score_wall_s"], "launches": counts,
                "uninterrupted": run["walls"]}
    print(f"  A preempt mid-scoring: Preempted after seed 0 ({p.signame}); resumed "
          f"run {wall:.3f} s, pretrain {summary['pretrain_wall_s']:.3f} s, score "
          f"{summary['score_wall_s']:.3f} s (uninterrupted: pretrain "
          f"{run['walls']['pretrain_wall_s']:.3f}, score "
          f"{run['walls']['score_wall_s']:.3f}); launches {counts}, tensor-core; "
          "scores, kept and final arrays bitwise equal", flush=True)

    # B. Preempt the retrain at epoch 0's end (scores reused from A: no
    # pretrain, nothing scored), then re-invoke: retrain:final resumes.
    dir_b = os.path.join(RES_DIR, "b")
    b_over = (f"score.scores_npz={T['scores_npz_path'](dir_a)}",)
    spe = -(-len(kept_a) // cfg.data.batch_size)
    p, counts, _ = counted(K, lambda: with_plan(
        port, {"sigterm_at_epoch_end": 0},
        lambda: expect_preempted(port, lambda: T["run_datadiet"](
            north_star_cfg(port, dir_b, TRAIN_N, *b_over), device="cuda"))))
    add(counts)
    check((p.durable_step, p.epoch) == (spe, 0),
          f"B: Preempted durable_step {p.durable_step} epoch {p.epoch}, want {spe}, 0")
    ev = Events()
    _, counts, _ = counted(K, lambda: T["run_datadiet"](
        north_star_cfg(port, dir_b, TRAIN_N, *b_over), device="cuda", log=ev))
    add(counts)
    check(not any(counts.values()), f"B: launches {counts}, want none")
    stage_ev = [(e["stage"], e["status"]) for e in ev.of("stage")]
    resumes = [(e["step"], e["epoch"]) for e in ev.of("resume")]
    check(("retrain:final", "resuming") in stage_ev and resumes == [(spe, 1)],
          f"B: stage events {stage_ev}, resumes {resumes}")
    step_b, arrays_b = ckpt_arrays(dir_b)
    check(arrays_equal(arrays_b, arrays_a), "B: final arrays differ from A's retrain")
    rec["B"] = {"durable_step": p.durable_step, "resumes": resumes}
    print(f"  B preempt at epoch end: durable step {p.durable_step}; retrain:final "
          f"resumed at step {resumes[0][0]}, epoch 1; final arrays bitwise equal to A's; "
          f"no launches", flush=True)

    # F. Truncate B's newest step: the resume falls back to the step before it.
    port["inject"].truncate_checkpoint(dir_b, step_b)
    cfg_b = north_star_cfg(port, dir_b, TRAIN_N, *b_over, "train.resume=true")
    train_ds, test_ds = T["load_data_for"](cfg_b)
    ev = Events()
    T["fit"](cfg_b, train_ds.subset(kept_a), test_ds, device="cuda", log=ev,
             checkpoint_dir=dir_b, tag="final")
    faults = [(e["fault"], e["step"]) for e in ev.of("fault")]
    resumes = [e["step"] for e in ev.of("resume")]
    check(faults == [("checkpoint_corrupt", step_b)] and resumes == [spe],
          f"F: faults {faults}, resumes {resumes}")
    check(arrays_equal(ckpt_arrays(dir_b)[1], arrays_b), "F: refit differs from B's")
    rec["F"] = {"faults": faults, "resume_step": resumes[0]}
    print(f"  F corrupt checkpoint: step {step_b} truncated, refused "
          f"(checkpoint_corrupt), fell back to step {resumes[0]}; final arrays bitwise "
          "equal to B's", flush=True)

    # C, D, E: plain fits of the recipe on RESUME_N examples (8 steps an epoch).
    small_cfg = train_cfg(port, "train.num_epochs=2", "train.checkpoint_every=1")
    rds = train_ds.subset(train_ds.indices[:RESUME_N])
    spe = -(-RESUME_N // TRAIN_B)
    whole = T["fit"](small_cfg, rds, None, device="cuda")

    # C. SIGTERM before step 2: the final synchronous save at step 3, epoch -1;
    # the resume replays epoch 0 with the counter continuing (at least once).
    dir_c = os.path.join(RES_DIR, "c")
    p = with_plan(port, {"sigterm_at_step": 2}, lambda: expect_preempted(
        port, lambda: T["fit"](small_cfg, rds, None, device="cuda", checkpoint_dir=dir_c)))
    meta = port["CheckpointManager"](dir_c).metrics(3)
    check((p.step, p.durable_step, p.epoch) == (3, 3, -1)
          and meta.get("preempted") is True and meta.get("epoch") == -1,
          f"C: Preempted step {p.step} durable {p.durable_step} epoch {p.epoch}, "
          f"saved metrics {meta}")
    c_cfg = copy.deepcopy(small_cfg)
    c_cfg.train.resume = True
    res = T["fit"](c_cfg, rds, None, device="cuda", checkpoint_dir=dir_c)
    check(res.state.step == 3 + 2 * spe, f"C: resumed to step {res.state.step}, "
          f"want {3 + 2 * spe}")
    rec["C"] = {"step": p.step, "final_step": res.state.step}
    print(f"  C preempt mid-epoch: final save at step 3 (epoch -1, preempted); resumed "
          f"to step {res.state.step} = 3 + 2 x {spe}", flush=True)

    # D. NaN at epoch 1: rollback to epoch 0's step at half the LR, bitwise the
    # fit resumed by hand from that checkpoint with optim.lr halved.
    dir_d = os.path.join(RES_DIR, "d")
    ev = Events()
    res = with_plan(port, {"nan_loss_at_epoch": 1}, lambda: T["fit_with_recovery"](
        small_cfg, rds, None, device="cuda", checkpoint_dir=dir_d, log=ev))
    faults = [e["fault"] for e in ev.of("fault")]
    recov = [(e["cause"], e["resume_step"], e["lr"]) for e in ev.of("recovery")]
    lr = small_cfg.optim.lr * small_cfg.resilience.nan_lr_factor
    check(faults == ["divergence"] and recov == [("divergence", spe, lr)],
          f"D: faults {faults}, recoveries {recov}")
    by_hand = os.path.join(RES_DIR, "d_by_hand")
    shutil.copytree(os.path.join(dir_d, f"step_{spe}"), os.path.join(by_hand, f"step_{spe}"))
    h_cfg = copy.deepcopy(small_cfg)
    h_cfg.optim.lr = lr
    h_cfg.train.resume = True
    want = T["fit"](h_cfg, rds, None, device="cuda", checkpoint_dir=by_hand)
    check(state_equal(torch, res.state, want.state),
          "D: rollback differs from a resume by hand at half the LR")
    rec["D"] = {"faults": faults, "recovery": recov}
    print(f"  D NaN rollback: divergence at epoch 1, resumed at step {spe} with lr {lr}; "
          "bitwise equal to a resume by hand", flush=True)

    # E. A hang in epoch 1: the watchdog turns it into a retry from epoch 0's step.
    dir_e = os.path.join(RES_DIR, "e")
    e_cfg = train_cfg(port, "train.num_epochs=2", "train.checkpoint_every=1",
                      f"resilience.step_timeout_s={HANG_TIMEOUT_S}",
                      "train.auto_resume_retries=1")
    ev = Events()
    t1 = time.perf_counter()
    res = with_plan(port, {"hang_at": spe + 2, "hang_seconds": 600},
                    lambda: T["fit_with_recovery"](e_cfg, rds, None, device="cuda",
                                                   checkpoint_dir=dir_e, log=ev))
    wall = time.perf_counter() - t1
    faults = [e for e in ev.of("fault")]
    check(len(faults) == 1 and faults[0]["fault"] == "hang"
          and "WatchdogTimeout" in faults[0]["error"], f"E: faults {faults}")
    check(wall < HANG_WALL_S, f"E: {wall:.1f} s of wall (limit {HANG_WALL_S})")
    check(state_equal(torch, res.state, whole.state), "E: differs from an uninterrupted fit")
    rec["E"] = {"wall_s": wall, "timeout_s": HANG_TIMEOUT_S}
    print(f"  E hang: WatchdogTimeout after {HANG_TIMEOUT_S} s, retried from step {spe}; "
          f"{wall:.3f} s of wall; bitwise equal to an uninterrupted fit", flush=True)

    # G. The real command line in a process of its own: exit 75 under a fault
    # plan, then the same command finishes.
    torch.cuda.empty_cache()
    dir_g = os.path.join(RES_DIR, "g")
    cmd = [sys.executable, "-m", "data_diet_distributed_tpu_torch.cli", "run",
           "--config", os.path.join(REPO, "configs", "cifar10_resnet18_grand10.yaml"),
           "data.dataset=synthetic", f"data.synthetic_size={G_N}", "score.seeds=[0,1]",
           "train.num_epochs=2", f"train.checkpoint_dir={dir_g}"]
    env = {k: v for k, v in os.environ.items() if k != "DDT_FAULT_PLAN"}
    env["PYTHONPATH"] = REPO
    walls = []
    for plan in ('{"sigterm_after_seed_scores": 1}', None):
        t1 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300,
                              env={**env, "DDT_FAULT_PLAN": plan} if plan else env)
        walls.append(time.perf_counter() - t1)
        if plan:
            check(proc.returncode == 75 and "[preempted]" in proc.stdout,
                  f"G: exit {proc.returncode}, stdout {proc.stdout[-300:]!r}, "
                  f"stderr {proc.stderr[-1500:]!r}")
        else:
            check(proc.returncode == 0, f"G rerun: exit {proc.returncode}, "
                                        f"stderr {proc.stderr[-1500:]!r}")
            out = json.loads(proc.stdout.strip().splitlines()[-1])
            check(out["event"] == "run_done" and out["n_kept"] == G_N // 2,
                  f"G rerun: {out}")
    rec["G"] = {"walls_s": walls}
    print(f"  G cli run ({G_N} examples): exit 75 with [preempted] under "
          f"DDT_FAULT_PLAN ({walls[0]:.1f} s), then exit 0, n_kept {G_N // 2} "
          f"({walls[1]:.1f} s)", flush=True)

    # The hooks' cost: fit's steady-epoch ex/s with resilience at its defaults
    # against preemption and the NaN check off, three alternating pairs.
    rates = {"on": [], "off": []}
    for i in range(OVERHEAD_PAIRS):
        for label in (("on", "off") if i % 2 == 0 else ("off", "on")):
            over = (() if label == "on" else
                    ("resilience.preemption=false", "resilience.nan_check=false"))
            hist = T["fit"](train_cfg(port, "train.num_epochs=2", *over), train_ds,
                            None, device="cuda").history
            rates[label].append(hist[1]["examples_per_s"])
    med = {k: statistics.median(v) for k, v in rates.items()}
    rec["overhead"] = {"examples_per_s": rates, "median": med,
                       "ratio_on_off": med["on"] / med["off"]}
    print(f"  hooks: steady epoch {med['on']:.1f} ex/s on vs {med['off']:.1f} off "
          f"(ratio {med['on'] / med['off']:.4f}; on {rates['on']}, off {rates['off']})",
          flush=True)
    return {"counts": total}


@contextlib.contextmanager
def bn_layout_spy(gb, seen: list):
    """Record, for every stacked-BN group the GraNd route scores, whether each
    layer's x and g are NHWC views of their memory (so the route's
    ``permute(0, 2, 3, 1).contiguous()`` copies nothing)."""
    orig = gb._bn_group_contrib

    def spy(items, *args, **kwargs):
        for _, x, g in items:
            seen.append(x.permute(0, 2, 3, 1).is_contiguous()
                        and g.permute(0, 2, 3, 1).is_contiguous())
        return orig(items, *args, **kwargs)
    gb._bn_group_contrib = spy
    try:
        yield
    finally:
        gb._bn_group_contrib = orig


def routes_phase(torch, port, details_out, card: str) -> dict:
    """Every launch-table route at full width: counts, ex/s, then parity."""
    gb, K = port["grand_batched"], port["kernels"]
    cfg = port["load_config"](os.path.join(REPO, "configs", "cifar10_resnet18.yaml"), [
        "data.dataset=synthetic", f"data.synthetic_size={ROUTE_N}",
        "score.pretrain_epochs=0", f"score.seeds={list(SEEDS)}",
        f"score.batch_size={B}", "train.half_precision=true"])
    ds, _ = port["load_dataset"]("synthetic", synthetic_size=ROUTE_N, seed=0)
    model = port["create_model_from_cfg"](cfg)
    variables = [port["init_variables"]("resnet18", s, "cuda") for s in SEEDS]
    runs = ROUTE_N // B * len(SEEDS)
    warm = ds.subset(ds.indices[:B])
    totals = dict.fromkeys(K.KERNELS, 0)
    results = {}
    for name, method, flags, per_batch in ROUTES:
        with toggles(gb, flags):
            port["score_dataset"](model, variables[:1], warm, method=method,
                                  batch_size=B, device="cuda")
            K.reset_launch_counts()
            views: list = []
            with bn_layout_spy(gb, views):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                scores = port["score_dataset"](model, variables, ds, method=method,
                                               batch_size=B, device="cuda")
                wall = time.perf_counter() - t0
            counts = K.launch_counts()
        if flags.get("USE_BN_KERNEL"):
            print(f"  route {name}: {sum(views)} of {len(views)} BatchNorm (x, g) pairs are "
                  "NHWC views (the stacked-BN kernel's inputs copy nothing)", flush=True)
            check(views and all(views), f"route {name}: a BatchNorm input or cotangent is "
                                        "not an NHWC view, so the route copies it")
        want = {k: per_batch.get(k, 0) * runs for k in K.KERNELS}
        check(counts == want, f"route {name}: launch counts {counts}, want {want}")
        for kern, modes in K.mode_counts().items():   # every bf16 launch on the tensor
            check_modes(K, dict.fromkeys(modes, 0), counts[kern],   # cores, BN in vector
                        route_mode(K, kern, torch.bfloat16), f"route {name}", kern)
        check(scores.shape == (ROUTE_N,) and bool(np.isfinite(scores).all())
              and bool((scores >= 0).all()), f"route {name}: scores not finite/>= 0")
        for k, n in counts.items():
            totals[k] += n
        ex_s = ROUTE_N * len(SEEDS) / wall
        results[name] = {"scores": scores, "wall_s": wall, "ex_per_s": ex_s,
                         "launches": {k: n for k, n in counts.items() if n}}
        print(f"  route {name}: {ROUTE_N} examples x {len(SEEDS)} seeds in {wall:.3f} s = "
              f"{ex_s:.1f} ex/s on {card}; launches per batch per seed "
              f"{ {k: n // runs for k, n in counts.items() if n} }", flush=True)

    # Each route against the default two-phase route: fp32, TF32 off, BN randomized.
    port["set_parity_mode"](True)
    cfg32 = port["load_config"](None, ["data.dataset=synthetic", "model.arch=resnet18",
                                       "train.half_precision=false"])
    model32 = port["create_model_from_cfg"](cfg32)
    v = bn_randomized(torch, port, 11)
    sub = ds.subset(ds.indices[:B])
    parity = {}

    def score32(method, data, batch_size=B, **kw):
        return port["score_dataset"](model32, [v], data, method=method,
                                     batch_size=batch_size, device="cuda", **kw)
    base = score32("grand", sub)
    for name, method, flags, _ in ROUTES[1:]:
        launches0, modes0 = K.launch_counts(), K.mode_counts()
        with toggles(gb, flags):
            got = score32(method, sub)
        for kern in modes0:   # every fp32 parity launch on the CUDA cores, BN in vector
            check_modes(K, modes0[kern], K.launch_counts()[kern] - launches0[kern],
                        route_mode(K, kern, torch.float32), f"route {name} fp32", kern)
        ref = base if method == "grand" else score32(method, sub, use_kernels=False)
        parity[name] = float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1e-30)))
        against = "default two-phase route" if method == "grand" else "plain route"
        print(f"  route {name} fp32 vs the {against} ({B} examples, BN randomized): "
              f"max rel err {parity[name]:.3e}", flush=True)
        check(parity[name] <= 1e-4, f"route {name}: rel err {parity[name]:.3e} > 1e-4")
    # grand_vmap (its own chunk of 32) on the first 64 examples against the default
    # route's batch-512 scores of them; both against the plain route in float64.
    n64 = 64
    sub64 = ds.subset(ds.indices[:n64])
    t0 = time.perf_counter()
    vmap = score32("grand_vmap", sub64, batch_size=n64, chunk=32)
    vmap_s = time.perf_counter() - t0
    batched = base[:n64]
    model64 = port["create_model_from_cfg"](cfg32).to("cuda").double()
    model64.dtype = torch.float64     # the ResNet casts its input to this type
    v64 = {k: t.double() for k, t in v.items()}
    ref64 = port["grand_batched"].batched_grand_scores(
        model64, v64, torch.from_numpy(sub64.images).to("cuda").double(),
        torch.from_numpy(sub64.labels).to("cuda"),
        torch.ones(n64, device="cuda", dtype=torch.float64)).cpu().numpy()

    def max_rel(got, ref):
        return float(np.max(np.abs(got - ref) / np.abs(ref)))
    parity.update(grand_vmap=max_rel(vmap, batched), grand_vmap_vs_fp64=max_rel(vmap, ref64),
                  grand_vs_fp64=max_rel(batched, ref64))
    print(f"  grand_vmap fp32 vs the default route ({n64} examples; chunk 32 against "
          f"batch {B}, {vmap_s:.3f} s): max rel err {parity['grand_vmap']:.3e}; against "
          f"the plain route in float64: grand_vmap {parity['grand_vmap_vs_fp64']:.3e}, "
          f"default route {parity['grand_vs_fp64']:.3e} (rtol 1e-4)", flush=True)
    check(bool(np.all(np.abs(vmap - batched) <= 1e-5 + 2e-4 * np.abs(batched))),
          "grand_vmap: not within rtol 2e-4, atol 1e-5 of grand")
    check(parity["grand_vmap_vs_fp64"] <= 1e-4 and parity["grand_vs_fp64"] <= 1e-4,
          "grand_vmap or grand: not within rtol 1e-4 of the float64 plain route")
    port["set_parity_mode"](False)
    details_out["routes"] = {n: {k: x for k, x in r.items() if k != "scores"}
                             for n, r in results.items()}
    details_out["route_parity"].update(parity)
    return {"cfg": cfg, "ds": ds, "variables": variables, "results": results,
            "counts": totals}


def serve_routes_phase(torch, port, routes, details_out) -> None:
    """``score_batch`` bitwise equal to ``full_scores`` on the last-layer kernel
    route and on the fused megakernel route."""
    ds = routes["ds"]
    rng = np.random.default_rng(1)
    with toggles(port["grand_batched"], MEGA_ROUTE):
        engine = port["ServeEngine"](routes["cfg"], device="cuda")
        engine.register_tenant("routes", ds, routes["variables"])
        for method, route in (("grand_last_layer", "grand_last_layer"),
                              ("grand", "FUSED+MEGAKERNEL")):
            full = engine.full_scores("routes", method)
            check(np.array_equal(full, routes["results"][route]["scores"]),
                  f"{route}: ServeEngine.full_scores differs from score_dataset")
            for n in (1, 100, 512):
                ids = rng.choice(ds.indices, size=n, replace=False)
                images, labels = engine.examples_for("routes", ids)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = engine.score_batch("routes", method, images, labels)
                ms = 1e3 * (time.perf_counter() - t0)
                want = full[engine.tenant("routes").pos_of(ids)]
                check(got.dtype == np.float32 and np.array_equal(got, want),
                      f"{route}: score_batch({n}) not bitwise equal to full_scores "
                      f"(max abs diff {np.abs(got - want).max():.3e})")
                details_out.setdefault("serve", {})[f"{route}_score_batch_{n}_ms"] = ms
                print(f"  {route}: score_batch({n}) bitwise equal to full_scores, "
                      f"{ms:.2f} ms", flush=True)


def serve_phase(torch, port, path, details_out) -> None:
    engine = port["ServeEngine"](path["cfg"], device="cuda")
    ds = path["ds"]
    engine.register_tenant("synthetic", ds, path["variables"])
    rng = np.random.default_rng(0)
    for method in ("el2n", "grand"):
        t0 = time.perf_counter()
        full = engine.full_scores("synthetic", method)
        full_s = time.perf_counter() - t0
        check(np.array_equal(full, path["results"][method]["scores"]),
              f"{method}: ServeEngine.full_scores differs from score_dataset")
        for n in (1, 100, 512):
            ids = rng.choice(ds.indices, size=n, replace=False)
            images, labels = engine.examples_for("synthetic", ids)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = engine.score_batch("synthetic", method, images, labels)
            ms = 1e3 * (time.perf_counter() - t0)
            want = full[engine.tenant("synthetic").pos_of(ids)]
            check(got.dtype == np.float32 and np.array_equal(got, want),
                  f"{method}: score_batch({n}) not bitwise equal to full_scores "
                  f"(max abs diff {np.abs(got - want).max():.3e})")
            print(f"  {method}: score_batch({n}) bitwise equal to full_scores, "
                  f"{ms:.2f} ms", flush=True)
            details_out.setdefault("serve", {})[f"{method}_score_batch_{n}_ms"] = ms
        top = list(engine.topk("synthetic", method, 10))
        order = np.lexsort((ds.indices, -full))[:10]
        check([i for i, _ in top] == [int(ds.indices[p]) for p in order],
              f"{method}: topk order")
        ids = rng.choice(ds.indices, size=64, replace=False)
        r_ids, r_scores = engine.rank("synthetic", method, ids)
        check(bool(np.all(np.diff(r_scores) <= 0)), f"{method}: rank not descending")
        check(sorted(r_ids.tolist()) == sorted(ids.tolist()), f"{method}: rank ids")
        kept = port["select_indices"](full, ds.indices, 0.5, keep="hardest")
        check(len(kept) == N_PATH // 2, f"{method}: kept {len(kept)}")
        print(f"  {method}: full_scores {full_s:.3f} s, topk(10) {top[:2]}..., "
              f"rank(64) ok, keep-hardest at sparsity 0.5 keeps {len(kept)}", flush=True)


# Device-time groups for the profile, by kernel name (first match wins).
PROFILE_GROUPS = (
    ("conv_grad_norm_direct", ("::direct_kernel<", "::direct_mma_kernel(",
                               "::finalize_kernel<")),
    ("conv_grad_norm_gram", ("::gram_kernel<",)),
    ("el2n", ("::el2n_kernel",)),
    ("conv_bwd_grad_norm (megakernel)", ("::bwd_norm_kernel(", "::bwd_norm_mma_kernel(")),
    ("conv_grad_norm_catdot", ("::catdot_kernel(", "::catdot_mma_kernel(")),
    ("bn_grad_norm", ("::bn_vector_kernel<", "::bn_scalar_kernel<")),
    ("grand_last_layer", ("::gll_kernel",)),
    ("cuDNN conv (forward, input gradient)", ("fprop", "dgrad", "cudnn", "nhwcAddPadding")),
    ("batch norm (forward, backward)", ("batch_norm",)),
    ("copies and dtype casts", ("copy", "Memcpy", "Memset", "CatArray")),
    ("cuBLAS (plain-route bmm, classifier)", ("gemm",)),
)


def _profile_group(name: str) -> str:
    for group, needles in PROFILE_GROUPS:
        if any(n in name for n in needles):
            return group
    return "other elementwise and reductions"


def _profile_batch(torch, port, path, out_dir: str, label: str) -> dict:
    """torch.profiler over one GraNd batch (one seed, 512 examples, the whole
    ``score_dataset`` call) on the route the toggles select: device time by
    kernel, the device-busy share of the call's wall, and the count of cuDNN
    input-gradient (dgrad) kernel launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ds = path["ds"].subset(path["ds"].indices[:B])
    model = port["create_model_from_cfg"](path["cfg"])
    args = dict(method="grand", batch_size=B, device="cuda")
    port["score_dataset"](model, path["variables"][:1], ds, **args)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        port["score_dataset"](model, path["variables"][:1], ds, **args)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    # Device-side events only (kernels, copies): operator rows also carry the
    # device time of the kernels they launch, so summing them would count it twice.
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = 1e-3 * sum(e.self_device_time_total for e in device)
    by_kernel = sorted(((e.key, 1e-3 * e.self_device_time_total) for e in device),
                       key=lambda kv: -kv[1])
    dgrad = sum(e.count for e in device if "dgrad" in e.key.lower())
    groups: dict[str, float] = {}
    for key, ms in by_kernel:
        groups[_profile_group(key)] = groups.get(_profile_group(key), 0.0) + ms
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_profile.txt"), "a") as fh:
        fh.write(f"== {label}\n")
        fh.write(events.table(sort_by="self_device_time_total", row_limit=40) + "\n")
    print(f"  {label}: one GraNd batch (512 examples, 1 seed): wall {wall_ms:.3f} ms under "
          f"the profiler, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f} %); cuDNN dgrad kernel launches: {dgrad}",
          flush=True)
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"    {ms:9.3f} ms  {100 * ms / busy_ms:5.1f} %  {group}", flush=True)
    for key, ms in by_kernel[:16]:
        print(f"    {ms:9.3f} ms  {key[:90]}", flush=True)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms, "dgrad_launches": dgrad,
            "device_ms_by_group": groups, "device_ms_by_kernel": by_kernel}


# Profiled routes: (label, DDT_GRAND_* module attributes, details key).
PROFILE_ROUTES = [
    ("default route", {}, "profile"),
    ("FUSED+MEGAKERNEL route", MEGA_ROUTE, "profile_megakernel"),
    ("BN_KERNEL route", {"USE_BN_KERNEL": True}, "profile_bn_kernel"),
    ("BN_KERNEL+GROUP_BN+GROUP_CONV route",
     {"USE_BN_KERNEL": True, "GROUP_BN": True, "GROUP_CONV": True}, "profile_bn_grouped"),
]


def profile_phase(torch, port, path, details_out, out_dir: str) -> None:
    """Profile one GraNd batch on the default route, the fused megakernel route
    and the two stacked-BN routes; report whether a cuDNN dgrad ran for the
    megakernel's layers, and hold each route's profiled BN and Gram kernel
    time per batch beside the kernel phase's device_ms sums."""
    os.makedirs(out_dir, exist_ok=True)
    open(os.path.join(out_dir, "chip_smoke_profile.txt"), "w").close()   # batches append
    for label, flags, key in PROFILE_ROUTES:
        with toggles(port["grand_batched"], flags):
            details_out[key] = _profile_batch(torch, port, path, out_dir, label)
    base = details_out["profile"]["dgrad_launches"]
    mega = details_out["profile_megakernel"]
    # The default route runs a dgrad for 19 convs (every conv but the stem); on the
    # megakernel route 10 of them get dx from the megakernel instead.
    print(f"  cuDNN dgrad launches per batch: default route {base}, megakernel route "
          f"{mega['dgrad_launches']}", flush=True)
    check(base > 0 and base % 19 == 0 and mega["dgrad_launches"] == base - 10 * base // 19,
          "a cuDNN dgrad ran for a megakernel layer (or none was identified by name)")
    # Cross-check: the kernel phase's device_ms (bf16, a run of launches on random
    # inputs), summed over the launches each route makes, against the profiler.
    rows = [r for r in details_out["kernels"] if r["dtype"] == "bfloat16"]

    def dev(kernel, **match):
        return sum(r["device_ms"] for r in rows if r["kernel"] == kernel
                   and all(r.get(k) == v for k, v in match.items()))
    want = {"profile": {"conv_grad_norm_gram": 3 * dev("conv_grad_norm_gram", x=[B, 4, 4, 512])},
            "profile_bn_kernel": {
                "bn_grad_norm": 5 * dev("bn_grad_norm", layers=1, layers_per_batch=5),
                "conv_grad_norm_gram": 3 * dev("conv_grad_norm_gram", x=[B, 4, 4, 512])},
            "profile_bn_grouped": {
                "bn_grad_norm": dev("bn_grad_norm", layers=5),
                "conv_grad_norm_gram": dev("conv_grad_norm_gram", x=[3 * B, 4, 4, 512])}}
    for key, kernels in want.items():
        got = details_out[key]["device_ms_by_group"]
        for kernel, ms in kernels.items():
            print(f"  {key}: {kernel} profiled {got.get(kernel, 0.0):.4f} ms per batch, "
                  f"device_ms sum {ms:.4f}", flush=True)
            details_out[key].setdefault("device_ms_sum", {})[kernel] = ms


def function_properties(log: str, needle: str) -> list[str]:
    """ptxas's stack and spill line of each kernel whose name contains ``needle``."""
    lines = log.splitlines()
    return [lines[i + 1].strip() for i, line in enumerate(lines[:-1])
            if "Function properties for" in line and needle in line]


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="profile GraNd batches with torch.profiler")
    parser.add_argument("--out", default=os.path.join(REPO, "chip_smoke_out"),
                        help="directory for the detail files")
    args = parser.parse_args(argv)
    import torch
    phase("device")
    check(torch.cuda.is_available(), "CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    try:
        from data_diet_distributed_tpu_torch.config import load_config
        from data_diet_distributed_tpu_torch.data import pipeline
        from data_diet_distributed_tpu_torch.data.datasets import ArrayDataset, load_dataset
        from data_diet_distributed_tpu_torch.device import (set_parity_mode,
                                                            set_scoring_determinism)
        from data_diet_distributed_tpu_torch.models import create_model, create_model_from_cfg
        from data_diet_distributed_tpu_torch.ops import build
        from data_diet_distributed_tpu_torch.ops import grand_batched
        from data_diet_distributed_tpu_torch.ops import kernels as K
        from data_diet_distributed_tpu_torch.ops.scoring import score_dataset
        from data_diet_distributed_tpu_torch.pruning import select_indices
        from data_diet_distributed_tpu_torch.pruning import verify_prune_manifest
        from data_diet_distributed_tpu_torch.checkpoint import CheckpointManager
        from data_diet_distributed_tpu_torch.resilience import inject
        from data_diet_distributed_tpu_torch.resilience.preemption import Preempted
        from data_diet_distributed_tpu_torch.resilience.stages import StageManifest
        from data_diet_distributed_tpu_torch.serve.engine import ServeEngine
        from data_diet_distributed_tpu_torch.train import loop, state, steps
        from data_diet_distributed_tpu_torch.weights import init_variables, variables_to
    except ImportError as err:
        fail(f"the port package is not importable next to this script: {err}")
    port = {"load_config": load_config, "load_dataset": load_dataset,
            "ArrayDataset": ArrayDataset, "set_parity_mode": set_parity_mode,
            "create_model": create_model,
            "create_model_from_cfg": create_model_from_cfg, "kernels": K,
            "grand_batched": grand_batched,
            "score_dataset": score_dataset, "select_indices": select_indices,
            "ServeEngine": ServeEngine, "init_variables": init_variables,
            "variables_to": variables_to,
            "set_scoring_determinism": set_scoring_determinism,
            "inject": inject, "Preempted": Preempted, "StageManifest": StageManifest,
            "CheckpointManager": CheckpointManager,
            "train": {"fit": loop.fit, "evaluate": loop.evaluate,
                      "fit_with_recovery": loop.fit_with_recovery,
                      "pipeline_fingerprint": loop.pipeline_fingerprint,
                      "load_data_for": loop.load_data_for,
                      "run_datadiet": loop.run_datadiet,
                      "score_variables_for_seeds": loop.score_variables_for_seeds,
                      "scores_npz_path": loop.scores_npz_path,
                      "verify_prune_manifest": verify_prune_manifest,
                      "create_train_state": state.create_train_state,
                      "state_from_variables": state.state_from_variables,
                      "make_optimizer": state.make_optimizer,
                      "train_step": steps.train_step,
                      "ResidentBatches": pipeline.ResidentBatches,
                      "maybe_resident": pipeline.maybe_resident,
                      "iterate_batches": pipeline.iterate_batches,
                      "to_device": pipeline.to_device}}
    details: dict = {"card": card, "torch": torch.__version__,
                     "cuda": torch.version.cuda}

    phase("build")
    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    print(f"  built {sorted(build.SOURCES)} in {build_s:.1f} s", flush=True)
    for name in sorted(build.SOURCES):
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"  [{name}] {line.strip()}", flush=True)
    # (kernel, function, instances): the bf16 modes on the tensor cores, and the
    # Gram kernel and the stacked-BN vector mode in both dtypes, must not spill.
    for name, fn, count in (("conv_grad_norm_direct", "direct_mma_kernel", 1),
                            ("conv_bwd_grad_norm", "bwd_norm_mma_kernel", 1),
                            ("conv_grad_norm_catdot", "catdot_mma_kernel", 1),
                            ("conv_grad_norm_gram", "gram_kernel", 2),
                            ("bn_grad_norm", "bn_vector_kernel", 2)):
        props = function_properties(build.build_log(name), fn)
        print(f"  {fn}: {props}", flush=True)
        check(len(props) == count
              and all("0 bytes spill stores, 0 bytes spill loads" in p for p in props),
              f"{name}: {fn} spills registers (or was not found): {props}")
    details["build_s"] = build_s

    phase("kernels")
    kernel_details: list = []
    set_parity_mode(True)   # the plain versions' fp32 products stay full fp32
    for dtype, rtol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-3)):
        kernel_phase(torch, K, dtype, rtol, kernel_details)
        route_kernel_phase(torch, K, dtype, rtol, kernel_details)
    set_parity_mode(False)
    details["kernels"] = kernel_details

    phase("path")
    path = path_phase(torch, port, details, card)

    phase("routes")
    routes = routes_phase(torch, port, details, card)

    phase("serve")
    serve_phase(torch, port, path, details)
    serve_routes_phase(torch, port, routes, details)

    phase("resnet50")
    r50 = resnet50_phase(torch, port, details, card)

    phase("train")
    trained = train_phase(torch, port, details, card)

    phase("resilience")
    resil = resilience_phase(torch, port, details, trained)

    phase("calls")
    calls_phase(torch)

    if args.profile:
        phase("profile")
        profile_phase(torch, port, path, details, args.out)

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as fh:
        json.dump(details, fh, indent=1)

    # One entry per kernel: per-batch sums over the layers of the route that runs
    # it, bf16; launches summed over the counted runs of the path, routes and
    # resnet50 phases, the train phase's run and the resilience phase's runs.
    launches = {k: path["counts"][k] + routes["counts"][k] + r50["counts"][k]
                + trained["counts"][k] + resil["counts"][k] for k in K.KERNELS}
    check(all(launches[k] > 0 for k in KERNEL_INFO), f"a kernel never launched: {launches}")
    entries = []
    for name, (source, replaces) in KERNEL_INFO.items():
        rows = [r for r in kernel_details if r["kernel"] == name]
        path_rows = [r for r in rows if r["dtype"] == "bfloat16"
                     and r["layers_per_batch"] > 0]
        t_ops = sum(r["layers_per_batch"] * r["bound_ms"] for r in path_rows
                    if r["bound_by"] == "operations")
        t_bytes = sum(r["layers_per_batch"] * r["bound_ms"] for r in path_rows
                      if r["bound_by"] == "bytes")
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["layers_per_batch"] * r["ms"] for r in path_rows),
            "device_ms": sum(r["layers_per_batch"] * r["device_ms"] for r in path_rows),
            "plain_ms": sum(r["layers_per_batch"] * r["plain_ms"] for r in path_rows),
            "bound_ms": t_ops + t_bytes,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
        })
    print("kernels: " + ", ".join(sorted(KERNEL_INFO)), flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
