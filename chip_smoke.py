#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py                # from the repo root, on a machine with a CUDA card
    python3 chip_smoke.py --profile      # also profile one GraNd batch (torch.profiler)
    python3 chip_smoke.py --out DIR      # where the detail files go (default chip_smoke_out/)

Phases (the first failure exits non-zero; nothing is caught):

1. Device: require CUDA; print ``nvidia-smi --query-gpu=name,power.limit``.
2. Build: compile every hand-written kernel from ``ops/csrc`` (one nvcc per
   source, in parallel) and print the build seconds and ptxas resource lines.
3. Kernels: hold each kernel against its plain PyTorch version at every
   ResNet-18 main-path geometry with B=512, in fp32 (TF32 off, rtol 1e-4) and
   bf16 (the same bf16 inputs on both sides, rtol 1e-3); time both with CUDA
   events (median after warm-up).
4. Path: full-width ResNet-18 on CIFAR-10-geometry synthetic data (8192
   examples, seeds [0, 1], batch 512, bf16) through ``score_dataset`` for
   ``el2n`` and ``grand``; check finite scores, the launch counts (12 direct,
   3 Gram, 1 EL2N per batch per seed) and ex/s; then, on BN-randomized fp32
   weights with TF32 off, the kernel route against the plain route end to end.
5. Serve: ``ServeEngine`` answers ``score_batch`` for 1, 100 and 512 ids
   bitwise equal to ``full_scores``, plus ``topk`` and ``rank``, for both
   methods; the keep-hardest count at sparsity 0.5.

The line before the last is a JSON object with one entry per kernel (launches
on the main path, max error, ms, plain ms, bound ms); the last line is
``{"ok": true, "device": {...}}``. Per-geometry details go to
``<out>/chip_smoke.json`` (and the profile table to ``<out>/chip_smoke_profile.txt``).
"""

from __future__ import annotations

import argparse
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


def kernel_phase(torch, K, dtype, rtol, details) -> None:
    """Each kernel against its plain version at every main-path geometry."""
    dname = str(dtype).replace("torch.", "")
    gen = torch.Generator(device="cuda").manual_seed(1234)
    for kernel, entry, xs, gs, ks, st, pad, layers in GEOMETRIES:
        x = torch.randn(xs, generator=gen, device="cuda").to(dtype)
        g = torch.randn(gs, generator=gen, device="cuda").to(dtype)
        if entry == "v1":
            def run():
                return K.conv_grad_norm_sq(x, g, ks, st, pad)

            def plain():
                return K.conv_grad_norm_sq_plain(x, g, ks, st, pad)
        elif entry == "v2":
            def run():
                return K.conv_grad_norm_sq_v2(x, g, ks, pad)

            def plain():
                return K.conv_grad_norm_sq_plain(x, g, ks, (1, 1), pad)
        else:
            def run():
                return K.conv_grad_norm_sq_gram(x, g, ks, pad)

            def plain():
                return K.conv_grad_norm_sq_gram_plain(x, g, ks, pad)
        got = run()
        torch.cuda.synchronize()
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
        details.append(rec)
        print(f"  {kernel}/{entry} {dname} x{list(xs)} g{list(gs)} k{ks} s{st}: "
              f"rel_err={rel:.3e} (rtol {rtol}) ms={rec['ms']:.4f} "
              f"plain_ms={rec['plain_ms']:.4f} "
              f"bound_ms={bnd:.4f} ({by})", flush=True)
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
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = port["score_dataset"](model, variables, ds, method=method,
                                       batch_size=B, device="cuda")
        wall = time.perf_counter() - t0
        after = K.launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        before = after
        check(scores.shape == (N_PATH,), f"{method}: scores shape {scores.shape}")
        check(bool(np.isfinite(scores).all()), f"{method}: non-finite scores")
        check(bool((scores >= 0).all()), f"{method}: negative scores")
        if method == "el2n":
            check(bool((scores <= np.sqrt(2) + 1e-6).all()), "el2n above sqrt(2)")
            want = {"conv_grad_norm_direct": 0, "conv_grad_norm_gram": 0,
                    "el2n": nb * len(SEEDS)}
        else:
            want = {"conv_grad_norm_direct": 12 * nb * len(SEEDS),
                    "conv_grad_norm_gram": 3 * nb * len(SEEDS), "el2n": 0}
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
    v = port["init_variables"]("resnet18", 7, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    for name, t in v.items():
        if t.dim() == 1 and not name.startswith("classifier"):
            if name.endswith("running_var"):
                v[name] = torch.rand(t.shape, generator=gen, device="cuda") + 0.5
            else:
                base = 1.0 if name.endswith(".weight") else 0.0
                v[name] = base + 0.3 * torch.randn(t.shape, generator=gen, device="cuda")
    sub = ds.subset(ds.indices[:2 * B])
    for method in ("grand", "el2n"):
        fast = port["score_dataset"](model32, [v], sub, method=method, batch_size=B,
                                     use_kernels=True, device="cuda")
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
    ("conv_grad_norm_direct", ("::direct_kernel<", "::finalize_kernel<")),
    ("conv_grad_norm_gram", ("::gram_kernel<",)),
    ("el2n", ("::el2n_kernel",)),
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


def profile_phase(torch, port, path, details_out, out_dir: str) -> None:
    """torch.profiler over one GraNd batch (one seed, 512 examples, the whole
    ``score_dataset`` call): device time by kernel to ``out_dir``, and the
    device-busy share of the call's wall."""
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
    groups: dict[str, float] = {}
    for key, ms in by_kernel:
        groups[_profile_group(key)] = groups.get(_profile_group(key), 0.0) + ms
    details_out["profile"] = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                              "device_busy_share": busy_ms / wall_ms,
                              "device_ms_by_group": groups,
                              "device_ms_by_kernel": by_kernel}
    table = events.table(sort_by="self_device_time_total", row_limit=40)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_profile.txt"), "w") as fh:
        fh.write(table)
    print(f"  one GraNd batch (512 examples, 1 seed): wall {wall_ms:.3f} ms under the "
          f"profiler, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f} %)", flush=True)
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"    {ms:9.3f} ms  {100 * ms / busy_ms:5.1f} %  {group}", flush=True)
    for key, ms in by_kernel[:16]:
        print(f"    {ms:9.3f} ms  {key[:90]}", flush=True)


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="profile one GraNd batch with torch.profiler")
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
    details["build_s"] = build_s

    phase("kernels")
    kernel_details: list = []
    set_parity_mode(True)   # the plain versions' fp32 products stay full fp32
    kernel_phase(torch, K, torch.float32, 1e-4, kernel_details)
    kernel_phase(torch, K, torch.bfloat16, 1e-3, kernel_details)
    set_parity_mode(False)
    details["kernels"] = kernel_details

    phase("path")
    path = path_phase(torch, port, details, card)

    phase("serve")
    serve_phase(torch, port, path, details)

    if args.profile:
        phase("profile")
        profile_phase(torch, port, path, details, args.out)

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as fh:
        json.dump(details, fh, indent=1)

    # One entry per kernel: per-batch sums over the main path's layers, bf16.
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
            "launches": path["counts"][name],
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
