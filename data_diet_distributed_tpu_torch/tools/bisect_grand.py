"""Bisect the batched-GraNd composition toggles on the card.

The port's copy of ``tools/bisect_grand.py``: the same combinations, arguments
and output, run without JAX::

    python -m data_diet_distributed_tpu_torch.tools.bisect_grand [--fast] [--size N] [--batch B]

Each combination runs the autotuner's measure child
(``python -m data_diet_distributed_tpu_torch.tools.autotune --measure-child``)
once, in its own process under the combination's environment, because
``ops/grand_batched.py`` reads the ``DDT_GRAND_*`` gates when it is imported.
The child times the production ``score_dataset`` pass and prints one JSON
line; this tool prints one result line per combination, writes every line to
``--out`` (default ``bisect_results.json``) with the winner marked, and stops
after the first combination whose child reports a backend ``"error"``.

Every combination pins all seven gates. The port turns ``STEM_XLA`` on by
default (``ops/grand_batched.py``), so an unpinned combination would inherit
it: ``baseline`` is the all-off program, and ``bn_kernel`` is the stacked-BN
kernel with the 3-channel stem on the direct kernel, not the default route
plus the BN kernel.

``--device`` (default ``cuda``) goes to every child; without a card and
without ``--device cpu`` the tool exits non-zero before any child starts.
"""

from __future__ import annotations

import argparse
import json
import sys

# Every toggle is pinned in every combo (off unless the combo names it):
# module-level defaults may change as bisections promote winners, and an
# unpinned combo would silently inherit them — "baseline" must always measure
# the all-off program.
_ALL_OFF = {f"DDT_GRAND_{k}": "0" for k in
            ("GROUP_CONV", "GROUP_BN", "BN_KERNEL", "CATDOT", "STEM_XLA",
             "FUSED", "MEGAKERNEL")}


def _combo(*on: str) -> dict:
    return {**_ALL_OFF, **{f"DDT_GRAND_{k}": "1" for k in on}}


# (name, env, extra measure-child args). The chunk arm pins the per-batch score
# engine (``--chunk 0``) against the chunked engine on the SAME kernel
# composition ("stem_xla" measures the auto chunking).
COMBOS = [
    ("baseline", _combo(), []),
    ("catdot", _combo("CATDOT"), []),
    ("bn_kernel", _combo("BN_KERNEL"), []),
    ("bn_kernel+catdot", _combo("BN_KERNEL", "CATDOT"), []),
    ("bn_kernel+group_bn", _combo("BN_KERNEL", "GROUP_BN"), []),
    ("group_conv", _combo("GROUP_CONV"), []),
    ("stem_xla", _combo("STEM_XLA"), []),
    ("bn_kernel+catdot+stem_xla", _combo("BN_KERNEL", "CATDOT", "STEM_XLA"),
     []),
    ("fused", _combo("FUSED"), []),
    ("fused+stem_xla", _combo("FUSED", "STEM_XLA"), []),
    ("megakernel", _combo("MEGAKERNEL"), []),
    ("megakernel+stem_xla", _combo("MEGAKERNEL", "STEM_XLA"), []),
    ("stem_xla+chunk0", _combo("STEM_XLA"), ["--chunk", "0"]),
]

FAST = ("baseline", "stem_xla", "megakernel", "megakernel+stem_xla",
        "stem_xla+chunk0")


def main(argv: list[str] | None = None) -> int:
    from . import autotune

    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=8192)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--arch", default="resnet18")
    ap.add_argument("--chunk", type=int, default=64,
                    help="grand_vmap chunk, the child's --grand-chunk (the "
                         "score-chunk arm carries its own --chunk in COMBOS)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--timeout", type=int, default=900)
    ap.add_argument("--fast", action="store_true",
                    help="curated 5-config race (expected winners only)")
    ap.add_argument("--out", default="bisect_results.json")
    ap.add_argument("--ledger", default=autotune.DEFAULT_LEDGER,
                    help="the children's perf_history ledger ('' disables)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, for every child")
    args = ap.parse_args(argv)
    err = autotune.device_error(args.device)
    if err:
        print(f"[bisect_grand] {err}", file=sys.stderr, flush=True)
        return 2
    measure = argparse.Namespace(
        task="score", method="grand", arch=args.arch, dataset="synthetic",
        size=args.size, batch=args.batch, grand_chunk=args.chunk,
        repeats=args.repeats, seeds=args.seeds, ledger=args.ledger,
        device=args.device, timeout=args.timeout)
    combos = [c for c in COMBOS if not args.fast or c[0] in FAST]
    results = []
    for name, env, extra_args in combos:
        line = autotune.measure_candidate(
            measure, {"name": name, "env": env, "extra": extra_args},
            combo_flag=False)
        rec = {"combo": name, "env": env, "args": extra_args, **line}
        print(f"{name:28s}: {rec.get('error') or json.dumps(line)}",
              flush=True)
        results.append(rec)
        # Abort ONLY for backend-unavailable failures (a missing card fails
        # every combo identically — one bounded failure is the signal).
        if "backend" in str(rec.get("error", "")):
            print(f"aborting: backend unavailable ({name!r})", flush=True)
            break
    ok = [r for r in results if not r.get("error") and r.get("value")]
    winner = max(ok, key=lambda r: r["value"]) if ok else None
    payload = {"results": results,
               "measured": len(ok), "requested": len(combos),
               "winner": winner["combo"] if winner else None,
               "winner_env": winner["env"] if winner else None}
    with open(args.out, "w") as fh:
        json.dump(payload, fh, indent=1)
    print(json.dumps({"winner": payload["winner"],
                      "winner_env": payload["winner_env"],
                      "out": args.out}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
