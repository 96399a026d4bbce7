#!/usr/bin/env python3
"""Time the tensor-core kernels with parts knocked out, on one CUDA card.

    python3 tools/direct_kernel_variants.py                     # every variant
    python3 tools/direct_kernel_variants.py base nostage        # some of them
    python3 tools/direct_kernel_variants.py --parent DIR        # also DIR's package

Each variant is a textual edit of the PyTorch port's sources in a copy of the
package under ``chip_smoke_out/variants/<name>/``, built there from the edited
sources. Each copy is timed in a process of its own, in bf16 on the same seeded
inputs (``chip_smoke.device_ms``: a run of launches replayed from a CUDA graph,
so the wrapper's host time is not in it), at ``chip_smoke.py``'s main-path
geometries: the direct kernel's five, the megakernel's three, cat-dot's one and
the Gram kernel's one.
It prints one JSON line: ms per launch at each geometry, ms per GraNd batch of
each kernel (weighted by the layers per batch on the route that runs it) and
ptxas's register lines. ``base`` runs first and last, so the spread between its
two lines is the noise of the call. The knock-outs compute wrong results on
purpose (only ``base`` and ``parent`` are held against the plain versions);
they show where the time goes:

* ``nostage``: nothing is copied into shared memory by the norm walk of
  ``conv_norm_mma.cuh`` (the MMA loop alone; the direct kernel, the
  megakernel's norm role and cat-dot);
* ``nomma``: the walk loads fragments but runs no ``mma.sync`` (staging and
  ``ldmatrix``);
* ``noldm_nomma``: neither (staging, barriers and the loop);
* ``mega_norm_only`` / ``mega_dx_only``: the megakernel with its dx blocks,
  or its norm blocks, doing nothing but exiting;
* ``gram_nostage`` / ``gram_nomma`` / ``gram_nogather``: the Gram kernel
  staging nothing, running no Gram chunk (``ldmatrix`` and ``mma.sync``), or
  skipping the offset gather and dot.

With ``--parent DIR`` the package under DIR (for example an unpacked parent
commit) runs too, as variant ``parent``, unedited, right after the first
``base``; the line after the last variant then says whether the direct
kernel's bf16 outputs of ``base`` and ``parent`` are bitwise equal at each
geometry.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "data_diet_distributed_tpu_torch"
HEADER = "conv_norm_mma.cuh"
MEGA = "conv_bwd_grad_norm.cu"
GRAM = "conv_grad_norm_gram.cu"

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

#: Variant -> (source under ops/csrc, old, new) edits.
VARIANTS = {
    "base": [],
    "nostage": [(HEADER, "    wk.stage(smem + i % kMmaStages",
                 "    if (nch < 0) wk.stage(smem + i % kMmaStages")],
    "nomma": [(HEADER, _MMA, _NO_MMA)],
    "noldm_nomma": [(HEADER, _MMA, _NO_MMA), (HEADER, _LDM_A, _NO_LDM_A),
                    (HEADER, _LDM_B, _NO_LDM_B)],
    "mega_norm_only": [(MEGA, "  } else {\n    dx_mma_role(",
                        "  } else if (norm_blocks < 0) {\n    dx_mma_role(")],
    "mega_dx_only": [(MEGA, "    mma_norm_walk(wk, smem, red, partials",
                      "    if (b < 0) mma_norm_walk(wk, smem, red, partials")],
    "gram_nostage": [(GRAM, "  while (e < nb) {", "  while (e < nb && vpr < 0) {")],
    "gram_nomma": [(GRAM, "gram_chunk(gram, rows, n, a.chunk, a.row_elems, lane);",
                    "if (n < 0) gram_chunk(gram, rows, n, a.chunk, a.row_elems, lane);")],
    "gram_nogather": [(GRAM, "for (int e = which * 32 + lane; e < a.S * a.S; e += 64) {",
                       "for (int e = a.S * a.S + which * 32 + lane; e < a.S * a.S; e += 64) {")],
}

_TIME = r'''
import json, sys
import numpy as np
import torch
sys.path[:0] = [sys.argv[1], sys.argv[2]]
from data_diet_distributed_tpu_torch.ops import build, kernels as K
import chip_smoke as cs
checked = sys.argv[3] in ("base", "parent")
build.build_all()
regs = {}
for lib, fn in (("conv_grad_norm_direct", "direct_mma_kernel"),
                ("conv_bwd_grad_norm", "bwd_norm_mma_kernel"),
                ("conv_grad_norm_catdot", "catdot_mma_kernel"),
                ("conv_grad_norm_gram", "gram_kernel")):
    log = build.build_log(lib).splitlines()
    regs[fn] = [log[i + 2].strip() for i, line in enumerate(log[:-2])
                if "Function properties for" in line and fn in line]
gen = torch.Generator(device="cuda").manual_seed(0)


def rel_err(got, ref):
    return float(((got.float() - ref.float()).abs() / ref.float().abs()).max())


out = {"variant": sys.argv[3], "registers": regs}
saved = {}
for kind in ("direct", "mega", "catdot", "gram"):
    per_geo, per_batch = [], 0.0
    if kind == "direct":
        rows = [(xs, gs, ks, st, pad, layers, entry)
                for kernel, entry, xs, gs, ks, st, pad, layers, _bias in cs.GEOMETRIES
                if kernel == "conv_grad_norm_direct" and layers]
    elif kind == "mega":
        rows = [(xs, gs, ks, (1, 1), pad, layers, None)
                for xs, gs, ks, pad, _bias, layers in cs.MEGA_GEOMETRIES if layers]
    elif kind == "gram":
        rows = [(xs, gs, ks, st, pad, layers, None)
                for kernel, entry, xs, gs, ks, st, pad, layers, _bias in cs.GEOMETRIES
                if kernel == "conv_grad_norm_gram" and layers]
    else:
        rows = [(xs, gs, ks, (1, 1), pad, layers, None)
                for xs, gs, ks, pad, layers in cs.CATDOT_GEOMETRIES if layers]
    for i, (xs, gs, ks, st, pad, layers, entry) in enumerate(rows):
        x = torch.randn(xs, generator=gen, device="cuda").bfloat16()
        g = torch.randn(gs, generator=gen, device="cuda").bfloat16()
        if kind == "direct":
            run = ((lambda: K.conv_grad_norm_sq(x, g, ks, st, pad)) if entry == "v1" else
                   (lambda: K.conv_grad_norm_sq_v2(x, g, ks, pad)))
            plain = lambda: K.conv_grad_norm_sq_plain(x, g, ks, st, pad)
        elif kind == "mega":
            w = torch.randn((gs[3], xs[3], *ks), generator=gen, device="cuda") * 0.05
            w = w.contiguous(memory_format=torch.channels_last)
            run = lambda: K.conv_bwd_grad_norm_sq(x, g, w, ks, pad)[1]
            plain = lambda: K.conv_bwd_grad_norm_sq_plain(x, g, w, ks, pad)[1]
        elif kind == "catdot":
            run = lambda: K.conv_grad_norm_sq_catdot(x, g, ks, pad)
            plain = lambda: K.conv_grad_norm_sq_catdot_plain(x, g, ks, pad)
        else:
            run = lambda: K.conv_grad_norm_sq_gram(x, g, ks, pad)
            plain = lambda: K.conv_grad_norm_sq_gram_plain(x, g, ks, pad)
        got = run()
        if checked:
            rel = rel_err(got, plain())
            assert rel <= 1e-3, f"{sys.argv[3]}: {kind} max rel err {rel:.3e} at x{xs}"
        saved[f"{kind}_{i}"] = got.float().cpu().numpy()
        ms = cs.device_ms(torch, run)
        per_geo.append({"x": list(xs), "g": list(gs), "kernel_size": list(ks),
                        "layers_per_batch": layers, "ms": ms})
        per_batch += layers * ms
    out[f"{kind}_ms_per_batch"] = per_batch
    out[f"{kind}_ms"] = [r["ms"] for r in per_geo]
if len(sys.argv) > 4:
    np.savez(sys.argv[4], **saved)
print(json.dumps(out), flush=True)
'''


def make_copy(name: str, root: str, src_repo: str = REPO) -> str:
    """The package of ``src_repo`` with variant ``name``'s edits, under ``root/name``."""
    dst = os.path.join(root, name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(src_repo, PACKAGE), os.path.join(dst, PACKAGE),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for source, old, new in VARIANTS.get(name, []):
        path = os.path.join(dst, PACKAGE, "ops", "csrc", source)
        with open(path) as fh:
            src = fh.read()
        if src.count(old) != 1:
            raise SystemExit(f"variant {name}: the edit does not apply to {source}: {old!r}")
        with open(path, "w") as fh:
            fh.write(src.replace(old, new))
    return dst


def main(argv: list[str]) -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("direct_kernel_variants: needs a CUDA card")
    parent = None
    if "--parent" in argv:
        i = argv.index("--parent")
        parent = os.path.abspath(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    names = argv or ["base", *[n for n in VARIANTS if n != "base"], "base"]
    unknown = sorted(set(names) - set(VARIANTS))
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: {sorted(VARIANTS)}")
    if parent is not None:
        names.insert(names.index("base") + 1 if "base" in names else 0, "parent")
    root = os.path.join(REPO, "chip_smoke_out", "variants")
    outputs = {}
    for name in names:
        src = parent if name == "parent" else REPO
        save = None
        if name in ("base", "parent") and name not in outputs:
            save = outputs[name] = os.path.join(root, f"{name}_outputs.npz")
        cmd = [sys.executable, "-c", _TIME, make_copy(name, root, src), REPO, name]
        proc = subprocess.run(cmd + ([save] if save else []), capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"variant {name} failed:\n{proc.stdout}{proc.stderr[-4000:]}")
        print(proc.stdout.strip(), flush=True)
    if "base" in outputs and "parent" in outputs:
        base, par = np.load(outputs["base"]), np.load(outputs["parent"])
        same = {k: bool(np.array_equal(base[k], par[k])) for k in sorted(base.files)
                if k.startswith("direct_")}
        print(json.dumps({"direct_bf16_bitwise_equal_to_parent": same}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
