#!/usr/bin/env python3
"""Device time of every hand-written kernel at its main-path shapes, on one CUDA card.

    python3 tools/kernel_device_times.py                  # the repo's package, twice
    python3 tools/kernel_device_times.py --parent DIR     # DIR's package too

Times each kernel of the PyTorch port in bf16 at ``chip_smoke.py``'s ResNet-18
main-path shapes (batch 512) with ``chip_smoke.device_ms``: a run of 20
launches captured in a CUDA graph, CUDA events around its replay, over the
count, so the wrappers' host time is not in the number. A row whose inputs fit
the 50 MB L2 is also timed cold, cycling through enough input copies that no
launch finds its inputs in L2. Each package runs in a process of its own on the
same seeded inputs, through its public wrappers only, so an older package
(an unpacked parent commit) can be timed beside the current one.

With ``--parent DIR`` the runs go parent, change, change, parent; without it,
change, change. Each run prints one JSON line: ms per launch at each shape,
and ms per GraNd batch of each kernel on the route that runs it. The last line
says, per kernel, whether the first change run's outputs are bitwise equal to
the first parent run's.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_TIME = r'''
import importlib.util, json, os, sys
import numpy as np
import torch
sys.path[:0] = [sys.argv[1]]     # the package under test; chip_smoke.py from this repo
from data_diet_distributed_tpu_torch.ops import kernels as K
spec = importlib.util.spec_from_file_location("chip_smoke",
                                              os.path.join(sys.argv[2], "chip_smoke.py"))
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
B = cs.B
gen = torch.Generator(device="cuda").manual_seed(0)


def randn(*shape):
    return torch.randn(shape, generator=gen, device="cuda").bfloat16()


# (kernel, label, launches per batch on the route that runs it, route, make): make()
# builds one copy of the row's inputs and returns (call, *input tensors).
rows = []
for kernel, entry, xs, gs, ks, st, pad, layers, bias in cs.GEOMETRIES:
    if xs[0] < B:
        continue
    route = "GROUP_CONV" if xs[0] > B else "default"
    def make(xs=xs, gs=gs, ks=ks, st=st, pad=pad, entry=entry, bias=bias):
        x, g = randn(*xs), randn(*gs)
        if entry == "v1":
            return (lambda: K.conv_grad_norm_sq(x, g, ks, st, pad)), x, g
        if entry == "v2":
            return (lambda: K.conv_grad_norm_sq_v2(x, g, ks, pad)), x, g
        return (lambda: K.conv_grad_norm_sq_gram(x, g, ks, pad, use_bias=bias)), x, g
    rows.append((kernel, f"x{list(xs)} g{list(gs)} k{list(ks)} s{list(st)}",
                 layers or 1, route, make))
for shape in cs.BN_SHAPES:
    for depth in (1, 5):
        def make(shape=shape, depth=depth):
            xs = [randn(*shape) for _ in range(depth)]
            gs = [randn(*shape) for _ in range(depth)]
            c = shape[-1]
            st = torch.stack([torch.randn((depth, c), generator=gen, device="cuda"),
                              torch.rand((depth, c), generator=gen, device="cuda") + 0.5], 1)
            return (lambda: K.bn_grad_norm_sq(xs, gs, st)), *xs, *gs
        rows.append(("bn_grad_norm", f"x{list(shape)} depth {depth}", 5 if depth == 1 else 1,
                     "BN_KERNEL" if depth == 1 else "BN_KERNEL+GROUP_BN", make))
# EL2N: the path's fp32 logits [512, 10], a wide [512, 1000], and bf16 logits with int64
# labels at both widths (an older wrapper casts both before its launch; the casts are
# in the timed run). Last-layer GraNd: ResNet-18's head and a ResNet-50's with 1,000
# classes, bf16 features.
for c, half, route in ((10, False, "el2n"), (1000, False, "el2n, 1,000 classes"),
                       (10, True, "el2n, bf16 logits"),
                       (1000, True, "el2n, bf16 logits, 1,000 classes")):
    def make_el2n(c=c, half=half):
        z = randn(B, c) if half else randn(B, c).float()
        y = torch.randint(0, c, (B,), generator=gen, device="cuda")
        m = torch.ones(B, device="cuda")
        return (lambda: K.el2n(z, y, m)), z
    rows.append(("el2n", f"logits[{B},{c}] {'bf16' if half else 'fp32'}", 1, route,
                 make_el2n))
for f, c, route in ((512, 10, "grand_last_layer"),
                    (2048, 1000, "grand_last_layer, ResNet-50 head, 1,000 classes")):
    def make_gll(f=f, c=c):
        h = randn(B, f)
        w = torch.randn((c, f), generator=gen, device="cuda") * f ** -0.5
        bias = torch.zeros(c, device="cuda")
        y = torch.randint(0, c, (B,), generator=gen, device="cuda")
        m = torch.ones(B, device="cuda")
        return (lambda: K.grand_last_layer(h, w, bias, y, m)), h, w
    rows.append(("grand_last_layer", f"[{B},{f}]->{c}", 1, route, make_gll))
for xs, gs, ks, pad, layers in cs.CATDOT_GEOMETRIES:
    if layers:
        def make(xs=xs, gs=gs, ks=ks, pad=pad):
            x, g = randn(*xs), randn(*gs)
            return (lambda: K.conv_grad_norm_sq_catdot(x, g, ks, pad)), x, g
        rows.append(("conv_grad_norm_catdot", f"x{list(xs)} k{list(ks)}", layers, "CATDOT",
                     make))
for xs, gs, ks, pad, bias, layers in cs.MEGA_GEOMETRIES:
    if layers:
        def make(xs=xs, gs=gs, ks=ks, pad=pad, bias=bias):
            x, g = randn(*xs), randn(*gs)
            w = torch.randn((gs[3], xs[3], *ks), generator=gen, device="cuda") * 0.05
            w = w.contiguous(memory_format=torch.channels_last)
            return (lambda: K.conv_bwd_grad_norm_sq(x, g, w, ks, pad, use_bias=bias)[1]), x, g
        rows.append(("conv_bwd_grad_norm", f"x{list(xs)} k{list(ks)}", layers,
                     "FUSED+MEGAKERNEL", make))

out = {"variant": sys.argv[3], "rows": [], "per_batch": {}}
saved = {}
for i, (kernel, label, launches, route, make) in enumerate(rows):
    call, *inputs = make()
    nbytes = sum(t.numel() * t.element_size() for t in inputs)
    saved[f"{kernel}_{i}"] = call().float().cpu().numpy()
    rec = {"kernel": kernel, "shape": label, "launches_per_batch": launches, "route": route,
           "input_bytes": nbytes, "device_ms": cs.device_ms(torch, call)}
    if nbytes <= cs.L2_BYTES:
        calls = [call] + [make()[0] for _ in range(cs.cold_copies(nbytes) - 1)]
        rec["device_cold_ms"] = cs.device_ms(torch, calls)
        del calls
    out["rows"].append(rec)
    # Per batch, warm and cold: a launch whose inputs exceed L2 is cold as timed.
    per = out["per_batch"].setdefault(f"{kernel} ({route})", {})
    for which, ms in (("device_ms", rec["device_ms"]),
                      ("device_cold_ms", rec.get("device_cold_ms", rec["device_ms"]))):
        per[which] = per.get(which, 0.0) + launches * ms
np.savez(sys.argv[4], **saved)
print(json.dumps(out), flush=True)
'''


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="root of another checkout (e.g. the parent commit)")
    args = parser.parse_args(argv)
    runs = [("change", REPO), ("change", REPO)]
    if args.parent:
        parent = os.path.abspath(args.parent)
        runs = [("parent", parent)] + runs + [("parent", parent)]
    first: dict[str, str] = {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, (variant, root) in enumerate(runs):
            npz = os.path.join(tmp, f"{i}.npz")
            proc = subprocess.run([sys.executable, "-c", _TIME, root, REPO, variant, npz],
                                  capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr, flush=True)
                return proc.returncode
            print(proc.stdout.strip().splitlines()[-1], flush=True)
            first.setdefault(variant, npz)
        if args.parent:
            a, b = np.load(first["change"]), np.load(first["parent"])
            same: dict[str, bool] = {}
            for key in a.files:
                kernel = key.rsplit("_", 1)[0]
                same[kernel] = same.get(kernel, True) and np.array_equal(a[key], b[key])
            print(json.dumps({"bitwise_equal_to_parent": same}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
