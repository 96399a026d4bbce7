#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py                # from the repo root, on a machine with a CUDA card
    python3 chip_smoke.py --profile      # also profile GraNd batches (torch.profiler)
    python3 chip_smoke.py --out DIR      # where the detail files go (default chip_smoke_out/)

Phases (the first failure exits non-zero; nothing is caught):

1. Device: require CUDA; print ``nvidia-smi --query-gpu=name,power.limit``.
2. Build: compile every hand-written kernel from ``ops/csrc`` (one nvcc per
   source, in parallel) and print the build seconds and ptxas resource lines;
   the tensor-core (bf16) modes of the direct, megakernel and cat-dot kernels
   must not spill registers.
3. Kernels: hold each kernel against its plain PyTorch version at every
   ResNet-18 main-path geometry with B=512, in fp32 (TF32 off, rtol 1e-4) and
   bf16 (the same bf16 inputs on both sides, rtol 1e-3); time both with CUDA
   events (median after warm-up). The direct kernel also at ragged
   geometries (batch 37; not in the per-batch sums), bitwise equal on a
   permutation of the batch and from run to run, with ``torch.bmm``'s bf16
   time of the same product Pᵀ G (im2col patches P made outside the timed
   call) beside each geometry as a yardstick (``bmm_ms``).
   The route kernels likewise: last-layer GraNd at [512, 512] -> 10 and
   [512, 2048] -> 1000, stacked BatchNorm at the four ResNet-18 BN shapes
   singly and 5 deep, cat-dot (``CATDOT_GEOMETRIES``: 16x16x128 and ragged
   ones at batch 37) with the direct kernel's time at the same layer as a
   yardstick (``direct_ms``), the megakernel (``MEGA_GEOMETRIES``: the
   stage-1/2/3 unit-stride geometries and ragged ones; its bf16 ``dx`` within
   two bf16 ulps, see ``MEGA_DX_TOL``) with a cuDNN input gradient plus the
   direct kernel's time as yardsticks (``dgrad_ms``, ``direct_ms``). Each
   launch of the direct, cat-dot and megakernel kernels is counted in the mode
   its dtype selects; in bf16 each is bitwise equal from run to run and on a
   permuted batch, and the megakernel's norm bitwise equal to the direct
   kernel's.
4. Path: full-width ResNet-18 on CIFAR-10-geometry synthetic data (8192
   examples, seeds [0, 1], batch 512, bf16) through ``score_dataset`` for
   ``el2n`` and ``grand``; check finite scores, the launch counts (12 direct,
   all in the tensor-core mode, 3 Gram, 1 EL2N per batch per seed) and ex/s;
   then, on BN-randomized fp32 weights with TF32 off, the kernel route (direct
   launches in the fp32 mode) against the plain route end to end.
5. Routes: every GraNd route (``ROUTES``: ``grand_last_layer`` and the
   ``DDT_GRAND_*`` toggles, set as module attributes and restored) at the
   same width on 1024 examples x 2 seeds: exact launch counts per batch per
   seed (every direct, cat-dot and megakernel launch in the tensor-core
   mode), ex/s; on BN-randomized fp32 weights with TF32 off (every such
   launch in the fp32 mode) each route against
   the default two-phase route (rtol 1e-4), and ``grand_vmap`` on 64 examples
   against it (rtol 2e-4, atol 1e-5); both against float64 (rtol 1e-4).
6. Serve: ``ServeEngine`` answers ``score_batch`` for 1, 100 and 512 ids
   bitwise equal to ``full_scores``, plus ``topk`` and ``rank``, for both
   methods; the keep-hardest count at sparsity 0.5. Then ``grand_last_layer``
   (kernel route) and ``grand`` on the fused megakernel route, bitwise too.

With ``--profile``: one default and one megakernel-route batch under
``torch.profiler``; the cuDNN dgrad launches must drop from 19 to 9.

Every counted run (phases 4 and 5) starts with the launch counts at 0 and is
read right after; the kernels line sums them. The line before the last is a
JSON object with one entry per kernel (launches on the main paths, max error,
ms, plain ms, bound ms); the last line is ``{"ok": true, "device": {...}}``.
Per-geometry details go to ``<out>/chip_smoke.json`` (and the profile tables to
``<out>/chip_smoke_profile.txt``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
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
# ResNet-18 at CIFAR-10 geometry with this shape, i.e. launches per GraNd batch)
GEOMETRIES = [
    ("conv_grad_norm_direct", "v1", (B, 32, 32, 64), (B, 32, 32, 64), (3, 3), (1, 1), PAD1, 4),
    ("conv_grad_norm_direct", "v1", (B, 32, 32, 64), (B, 16, 16, 128), (3, 3), (2, 2), PAD1, 1),
    ("conv_grad_norm_direct", "v1", (B, 32, 32, 64), (B, 16, 16, 128), (1, 1), (2, 2), PAD0, 1),
    ("conv_grad_norm_direct", "v2", (B, 16, 16, 128), (B, 16, 16, 128), (3, 3), (1, 1), PAD1, 3),
    ("conv_grad_norm_direct", "v2", (B, 8, 8, 256), (B, 8, 8, 256), (3, 3), (1, 1), PAD1, 3),
    ("conv_grad_norm_gram", "gram", (B, 4, 4, 512), (B, 4, 4, 512), (3, 3), (1, 1), PAD1, 3),
    # Ragged direct geometries, on no ResNet-18 path: C and K off the 64 tile, a
    # strided 9x9 input, C not a multiple of 8, asymmetric padding; batch 37.
    ("conv_grad_norm_direct", "v2", (37, 12, 12, 72), (37, 12, 12, 136), (3, 3), (1, 1), PAD1, 0),
    ("conv_grad_norm_direct", "v1", (37, 9, 9, 48), (37, 5, 5, 80), (3, 3), (2, 2), PAD1, 0),
    ("conv_grad_norm_direct", "v1", (37, 10, 10, 20), (37, 10, 10, 24), (3, 3), (1, 1), PAD1, 0),
    ("conv_grad_norm_direct", "v1", (37, 11, 11, 64), (37, 11, 11, 40), (3, 3), (1, 1),
     ((0, 2), (2, 0)), 0),
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
    """Median device time of one call, by CUDA events."""
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


def kernel_phase(torch, K, dtype, rtol, details) -> None:
    """Each kernel against its plain version at every main-path geometry."""
    dname = str(dtype).replace("torch.", "")
    gen = torch.Generator(device="cuda").manual_seed(1234)
    for kernel, entry, xs, gs, ks, st, pad, layers in GEOMETRIES:
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
            def call(x, g):
                return K.conv_grad_norm_sq_gram(x, g, ks, pad)

            def plain():
                return K.conv_grad_norm_sq_gram_plain(x, g, ks, pad)

        def run():
            return call(x, g)
        modes0 = K.mode_counts()["conv_grad_norm_direct"]
        got = run()
        torch.cuda.synchronize()
        if kernel == "conv_grad_norm_direct":
            check_modes(K, modes0, 1, K.DIRECT_MODES[dtype], f"{kernel}/{entry} {dname}")
            check_bitwise(torch, gen, call, x, g, got, f"{kernel}/{entry} {dname} x{list(xs)}")
        ref = plain()
        err = (got - ref).abs()
        rel = float((err / ref.abs().clamp_min(1e-30)).max())
        flops, nbytes = conv_work(kernel, xs, gs, ks, x.element_size())
        bnd, by = bound_ms(flops, nbytes, dname)
        rec = {"kernel": kernel, "entry": entry, "dtype": dname, "x": list(xs),
               "g": list(gs), "kernel_size": list(ks), "strides": list(st),
               "layers_per_batch": layers, "max_abs_err": float(err.max()),
               "max_rel_err": rel, "ms": time_ms(torch, run),
               "plain_ms": time_ms(torch, plain, warmup=1, iters=3),
               "bound_ms": bnd, "bound_by": by}
        if kernel == "conv_grad_norm_direct" and dtype == torch.bfloat16:
            # Yardstick, not a library counterpart: one bf16 bmm of the same
            # product P^T G (no norm), with the patches P made outside the call.
            p = K.patches(x, ks, st, pad, gs[1:3]).to(dtype)
            g2 = g.reshape(gs[0], gs[1] * gs[2], gs[3])
            rec["bmm_ms"] = time_ms(torch, lambda: torch.bmm(p.transpose(1, 2), g2))
            del p
        details.append(rec)
        print(f"  {kernel}/{entry} {dname} x{list(xs)} g{list(gs)} k{ks} s{st}: "
              f"rel_err={rel:.3e} (rtol {rtol}) ms={rec['ms']:.4f} "
              f"plain_ms={rec['plain_ms']:.4f} "
              f"bound_ms={bnd:.4f} ({by})"
              + (f" bmm_ms={rec['bmm_ms']:.4f}" if "bmm_ms" in rec else ""), flush=True)
        check(bool(torch.isfinite(got).all()), f"{kernel}/{entry} {dname}: non-finite")
        check(rel <= rtol, f"{kernel}/{entry} {dname} x{list(xs)}: max rel err "
                           f"{rel:.3e} > {rtol}")
    # EL2N at the path's logits geometry [512, 10] and a wide one [512, 1000].
    for c in (10, 1000):
        z = (torch.randn((B, c), generator=gen, device="cuda") * 3).to(dtype).float()
        y = torch.randint(0, c, (B,), generator=gen, device="cuda")
        m = (torch.rand(B, generator=gen, device="cuda") > 0.1).float()
        got, ref = K.el2n(z, y, m), K.el2n_plain(z, y, m)
        err = (got - ref).abs()
        rel = float((err / ref.abs().clamp_min(1e-6)).max())
        nbytes = B * c * 4 + B * 8 + B * 4 + B * 4
        bnd, by = bound_ms(5.0 * B * c, nbytes, "float32")
        rec = {"kernel": "el2n", "entry": "el2n", "dtype": dname, "logits": [B, c],
               "layers_per_batch": 1 if c == 10 else 0,
               "max_abs_err": float(err.max()), "max_rel_err": rel,
               "ms": time_ms(torch, lambda: K.el2n(z, y, m)),
               "plain_ms": time_ms(torch, lambda: K.el2n_plain(z, y, m), 1, 3),
               "bound_ms": bnd, "bound_by": by}
        details.append(rec)
        print(f"  el2n logits[{B},{c}] ({dname} inputs): abs_err={rec['max_abs_err']:.3e} "
              f"ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f}", flush=True)
        check(rel <= max(rtol, 1e-5) or float(err.max()) <= 1e-6,
              f"el2n C={c}: max rel err {rel:.3e}")


def _measure(torch, rec: dict, run, plain, flops: float, nbytes: float,
             peak: str) -> dict:
    """Fill ``rec`` with the kernel's and the plain version's median times and
    the bound of ``flops`` at the ``peak`` type's rate and ``nbytes``."""
    bnd, by = bound_ms(flops, nbytes, peak)
    rec.update(ms=time_ms(torch, run), plain_ms=time_ms(torch, plain, warmup=1, iters=3),
               bound_ms=bnd, bound_by=by)
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

    # Last-layer GraNd: features in the working type, cast to fp32 by the route.
    for f, c, layers in ((512, 10, 1), (2048, 1000, 0)):
        h = randn(B, f)
        w = torch.randn((c, f), generator=gen, device="cuda") * f ** -0.5
        bias = 0.1 * torch.randn(c, generator=gen, device="cuda")
        y = torch.randint(0, c, (B,), generator=gen, device="cuda")
        m = (torch.rand(B, generator=gen, device="cuda") > 0.1).float()
        got, ref = K.grand_last_layer(h, w, bias, y, m), K.grand_last_layer_plain(h, w, bias, y, m)
        abs_err, rel = _rel_err(got, ref)
        rec = _measure(torch, {"kernel": "grand_last_layer", "entry": "gll", "dtype": dname,
                               "features": [B, f], "classes": c, "layers_per_batch": layers,
                               "max_abs_err": abs_err, "max_rel_err": rel},
                       lambda: K.grand_last_layer(h, w, bias, y, m),
                       lambda: K.grand_last_layer_plain(h, w, bias, y, m),
                       2.0 * B * f * c + 2.0 * B * f + 6.0 * B * c,
                       4.0 * (B * f + c * f + c + 3 * B), "float32")
        details.append(rec)
        print(f"  grand_last_layer {dname} [{B},{f}]->{c}: rel_err={rel:.3e} "
              f"ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
              f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']})", flush=True)
        check(bool(torch.isfinite(got).all()) and rel <= rtol,
              f"grand_last_layer {dname} F={f}: max rel err {rel:.3e} > {rtol}")
    # Stacked BatchNorm: every ResNet-18 BN shape, one layer (5 launches per batch on
    # the BN_KERNEL route) and 5 deep (1 launch per batch with GROUP_BN).
    for shape in BN_SHAPES:
        c = shape[-1]
        for depth in (1, 5):
            xs = [randn(*shape) for _ in range(depth)]
            gs = [randn(*shape) for _ in range(depth)]
            stats = torch.stack([torch.randn((depth, c), generator=gen, device="cuda"),
                                 torch.rand((depth, c), generator=gen, device="cuda") + 0.5],
                                dim=1)
            got = K.bn_grad_norm_sq(xs, gs, stats)
            ref = K.bn_grad_norm_sq_plain(xs, gs, stats)
            abs_err, rel = _rel_err(got, ref)
            n = depth * float(np.prod(shape))
            rec = _measure(torch, {"kernel": "bn_grad_norm", "entry": "bn", "dtype": dname,
                                   "x": list(shape), "layers": depth,
                                   "layers_per_batch": 5 if depth == 1 else 0,
                                   "max_abs_err": abs_err, "max_rel_err": rel},
                           lambda: K.bn_grad_norm_sq(xs, gs, stats),
                           lambda: K.bn_grad_norm_sq_plain(xs, gs, stats),
                           3.0 * n, 2.0 * n * item + 8.0 * depth * c + 4.0 * depth * B,
                           "float32")
            details.append(rec)
            print(f"  bn_grad_norm {dname} x{list(shape)} x{depth}: rel_err={rel:.3e} "
                  f"ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
                  f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']})", flush=True)
            check(bool(torch.isfinite(got).all()) and rel <= rtol,
                  f"bn_grad_norm {dname} {shape} x{depth}: max rel err {rel:.3e} > {rtol}")
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
              f"ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
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


def bn_randomized(torch, port, seed: int) -> dict:
    """ResNet-18 variables with every BatchNorm randomized (at init the
    closing BN scale is zero, which would zero half the convs' cotangents)
    and the classifier scaled by ``PARITY_CLASSIFIER_SCALE``."""
    v = port["init_variables"]("resnet18", seed, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for name, t in v.items():
        if t.dim() == 1 and not name.startswith("classifier"):
            if name.endswith("running_var"):
                v[name] = torch.rand(t.shape, generator=gen, device="cuda") + 0.5
            else:
                base = 1.0 if name.endswith(".weight") else 0.0
                v[name] = base + 0.3 * torch.randn(t.shape, generator=gen, device="cuda")
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
        modes0 = K.mode_counts()["conv_grad_norm_direct"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = port["score_dataset"](model, variables, ds, method=method,
                                       batch_size=B, device="cuda")
        wall = time.perf_counter() - t0
        after = K.launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        before = after
        check_modes(K, modes0, delta["conv_grad_norm_direct"], "tensor_core", method)
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
        modes0 = K.mode_counts()["conv_grad_norm_direct"]
        fast = port["score_dataset"](model32, [v], sub, method=method, batch_size=B,
                                     use_kernels=True, device="cuda")
        check_modes(K, modes0, 12 * 2 if method == "grand" else 0, "fp32",
                    f"{method} fp32")
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
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scores = port["score_dataset"](model, variables, ds, method=method,
                                           batch_size=B, device="cuda")
            wall = time.perf_counter() - t0
            counts = K.launch_counts()
        want = {k: per_batch.get(k, 0) * runs for k in K.KERNELS}
        check(counts == want, f"route {name}: launch counts {counts}, want {want}")
        for kern in K.mode_counts():   # every bf16 launch on the tensor cores
            check_modes(K, dict.fromkeys(K.DIRECT_MODES.values(), 0), counts[kern],
                        "tensor_core", f"route {name}", kern)
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
        for kern in modes0:   # every fp32 parity launch on the CUDA cores
            check_modes(K, modes0[kern], K.launch_counts()[kern] - launches0[kern], "fp32",
                        f"route {name} fp32", kern)
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
    ("bn_grad_norm", ("::bn_kernel<",)),
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


def profile_phase(torch, port, path, details_out, out_dir: str) -> None:
    """Profile one default-route GraNd batch and one on the fused megakernel
    route, and report whether a cuDNN dgrad ran for the megakernel's layers."""
    os.makedirs(out_dir, exist_ok=True)
    open(os.path.join(out_dir, "chip_smoke_profile.txt"), "w").close()   # batches append
    details_out["profile"] = _profile_batch(torch, port, path, out_dir, "default route")
    with toggles(port["grand_batched"], MEGA_ROUTE):
        mega = _profile_batch(torch, port, path, out_dir, "FUSED+MEGAKERNEL route")
    details_out["profile_megakernel"] = mega
    base = details_out["profile"]["dgrad_launches"]
    # The default route runs a dgrad for 19 convs (every conv but the stem); on the
    # megakernel route 10 of them get dx from the megakernel instead.
    print(f"  cuDNN dgrad launches per batch: default route {base}, megakernel route "
          f"{mega['dgrad_launches']}", flush=True)
    check(base > 0 and base % 19 == 0 and mega["dgrad_launches"] == base - 10 * base // 19,
          "a cuDNN dgrad ran for a megakernel layer (or none was identified by name)")


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
        from data_diet_distributed_tpu_torch.data.datasets import load_dataset
        from data_diet_distributed_tpu_torch.device import set_parity_mode
        from data_diet_distributed_tpu_torch.models import create_model_from_cfg
        from data_diet_distributed_tpu_torch.ops import build
        from data_diet_distributed_tpu_torch.ops import grand_batched
        from data_diet_distributed_tpu_torch.ops import kernels as K
        from data_diet_distributed_tpu_torch.ops.scoring import score_dataset
        from data_diet_distributed_tpu_torch.pruning import select_indices
        from data_diet_distributed_tpu_torch.serve.engine import ServeEngine
        from data_diet_distributed_tpu_torch.weights import init_variables
    except ImportError as err:
        fail(f"the port package is not importable next to this script: {err}")
    port = {"load_config": load_config, "load_dataset": load_dataset,
            "set_parity_mode": set_parity_mode,
            "create_model_from_cfg": create_model_from_cfg, "kernels": K,
            "grand_batched": grand_batched,
            "score_dataset": score_dataset, "select_indices": select_indices,
            "ServeEngine": ServeEngine, "init_variables": init_variables}
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
    for name, fn in (("conv_grad_norm_direct", "direct_mma_kernel"),
                     ("conv_bwd_grad_norm", "bwd_norm_mma_kernel"),
                     ("conv_grad_norm_catdot", "catdot_mma_kernel")):
        mma = function_properties(build.build_log(name), fn)
        print(f"  {fn} (bf16, tensor cores): {mma}", flush=True)
        check(len(mma) == 1 and "0 bytes spill stores, 0 bytes spill loads" in mma[0],
              f"{name}'s tensor-core mode spills registers (or was not found): {mma}")
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

    if args.profile:
        phase("profile")
        profile_phase(torch, port, path, details, args.out)

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as fh:
        json.dump(details, fh, indent=1)

    # One entry per kernel: per-batch sums over the layers of the route that runs
    # it, bf16; launches summed over the counted runs of the path and routes phases.
    launches = {k: path["counts"][k] + routes["counts"][k] for k in K.KERNELS}
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
