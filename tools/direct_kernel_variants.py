#!/usr/bin/env python3
"""Time the direct kernel's tensor-core mode with parts knocked out, on one CUDA card.

    python3 tools/direct_kernel_variants.py                  # every variant
    python3 tools/direct_kernel_variants.py base nostage     # some of them

Each variant is a textual edit of the PyTorch port's
``ops/csrc/conv_grad_norm_direct.cu`` in a copy of the package under
``chip_smoke_out/variants/<name>/``, built there from the edited source. Each
copy is timed in a process of its own at the five ResNet-18 main-path direct
geometries of ``chip_smoke.py`` (bf16, B = 512; CUDA events, median of 15
launches) and prints one JSON line: ms per launch at each geometry, ms per
GraNd batch (weighted by the layers per batch) and ptxas's register line of
the kernel. ``base`` runs first and last, so the spread between its two lines
is the noise of the call. The knock-outs compute wrong results on purpose
(only ``base`` is held against the plain version); they show where the time
goes:

* ``nostage``: nothing is copied into shared memory (the MMA loop alone);
* ``nomma``: fragments are loaded but no ``mma.sync`` runs (staging and
  ``ldmatrix``);
* ``noldm_nomma``: neither (staging, barriers and the loop).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = "conv_grad_norm_direct.cu"

_MMA = """mma_bf16(acc[j][mt][nt], afr[mt], bfr[nt >> 1][(nt & 1) * 2],
                         bfr[nt >> 1][(nt & 1) * 2 + 1]);"""
_NO_MMA = "acc[j][mt][nt][0] += __uint_as_float(afr[mt][nt & 3] ^ bfr[nt >> 1][(nt & 1) * 2]);"
_LDM_A = """ldsm_x4_trans(afr[0], aa);
            ldsm_x4_trans(afr[1], aa + 32);"""
_NO_LDM_A = "afr[0][0] = afr[0][1] = afr[0][2] = afr[0][3] = aa + t;" \
            " afr[1][0] = afr[1][1] = afr[1][2] = afr[1][3] = aa + 32;"
_LDM_B = """ldsm_x4_trans(bfr[0], ga);
        ldsm_x4_trans(bfr[1], ga + 32);"""
_NO_LDM_B = "bfr[0][0] = bfr[0][1] = bfr[0][2] = bfr[0][3] = ga;" \
            " bfr[1][0] = bfr[1][1] = bfr[1][2] = bfr[1][3] = ga + 32;"

#: Variant -> (old, new) edits of the source.
VARIANTS = {
    "base": [],
    "nostage": [("    stage_chunk(smem + i % kMmaStages",
                 "    if (nch < 0) stage_chunk(smem + i % kMmaStages")],
    "nomma": [(_MMA, _NO_MMA)],
    "noldm_nomma": [(_MMA, _NO_MMA), (_LDM_A, _NO_LDM_A), (_LDM_B, _NO_LDM_B)],
}

_TIME = r'''
import json, sys
import torch
sys.path[:0] = [sys.argv[1], sys.argv[2]]
from data_diet_distributed_tpu_torch.ops import build, kernels as K
import chip_smoke as cs
build.build_all()
log = build.build_log("conv_grad_norm_direct").splitlines()
regs = [log[i + 2].strip() for i, line in enumerate(log[:-2])
        if "Function properties for" in line and "direct_mma_kernel" in line]
gen = torch.Generator(device="cuda").manual_seed(0)
per_geo, per_batch = [], 0.0
for kernel, entry, xs, gs, ks, st, pad, layers in cs.GEOMETRIES:
    if kernel != "conv_grad_norm_direct" or not layers:
        continue
    x = torch.randn(xs, generator=gen, device="cuda").bfloat16()
    g = torch.randn(gs, generator=gen, device="cuda").bfloat16()
    if entry == "v1":
        run = lambda: K.conv_grad_norm_sq(x, g, ks, st, pad)
    else:
        run = lambda: K.conv_grad_norm_sq_v2(x, g, ks, pad)
    if sys.argv[3] == "base":
        ref = K.conv_grad_norm_sq_plain(x, g, ks, st, pad)
        rel = float(((run() - ref).abs() / ref.abs()).max())
        assert rel <= 1e-3, f"base variant: max rel err {rel:.3e} at x{xs}"
    ms = cs.time_ms(torch, run, warmup=3, iters=15)
    per_geo.append({"x": list(xs), "g": list(gs), "kernel_size": list(ks),
                    "strides": list(st), "layers_per_batch": layers, "ms": ms})
    per_batch += layers * ms
print(json.dumps({"variant": sys.argv[3], "ms_per_batch": per_batch,
                  "ms": [r["ms"] for r in per_geo], "registers": regs,
                  "geometries": per_geo}), flush=True)
'''


def make_copy(name: str, root: str) -> str:
    """The package with variant ``name``'s edits, under ``root/name``."""
    dst = os.path.join(root, name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, "data_diet_distributed_tpu_torch"),
                    os.path.join(dst, "data_diet_distributed_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = os.path.join(dst, "data_diet_distributed_tpu_torch", "ops", "csrc", SOURCE)
    with open(path) as fh:
        src = fh.read()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise SystemExit(f"variant {name}: the edit does not apply to {SOURCE}: {old!r}")
        src = src.replace(old, new)
    with open(path, "w") as fh:
        fh.write(src)
    return dst


def main(argv: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("direct_kernel_variants: needs a CUDA card")
    names = argv or ["base", *[n for n in VARIANTS if n != "base"], "base"]
    unknown = sorted(set(names) - set(VARIANTS))
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: {sorted(VARIANTS)}")
    root = os.path.join(REPO, "chip_smoke_out", "variants")
    for name in names:
        proc = subprocess.run([sys.executable, "-c", _TIME, make_copy(name, root), REPO, name],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"variant {name} failed:\n{proc.stdout}{proc.stderr[-4000:]}")
        print(proc.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
