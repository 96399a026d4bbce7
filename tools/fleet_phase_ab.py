"""Time ``chip_smoke.py``'s fleet phase of two versions of the script in one call.

    python3 tools/fleet_phase_ab.py --parent OTHER/chip_smoke.py [--rounds 2] [--out DIR]

Both versions drive this checkout's port (its package, its kernels, its
``chip_smoke_out/``): the parent's script is executed with its ``REPO`` set to
this checkout, so only the phase's own code differs. After the build and the
``path`` phase, the phases run in the order parent, change, change, parent
(``--rounds`` pairs), since the load of a shared host moves one run's wall by
a fifth or more. Prints each run's wall, boots, respawn wall, roll walls and
router latency, and writes them to ``DIR/fleet_phase_ab.json``. Needs a CUDA
card; exits 1 at the first failed gate of either version.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_parent(path: str):
    """The parent's ``chip_smoke.py`` as a module whose ``REPO`` is this checkout."""
    with open(path) as fh:
        src = fh.read()
    anchor = "REPO = os.path.dirname(os.path.abspath(__file__))"
    if anchor not in src:
        raise SystemExit(f"{path}: no `{anchor}` line to point at this checkout")
    src = src.replace(anchor, f"REPO = {REPO!r}", 1)
    mod = importlib.util.module_from_spec(
        importlib.util.spec_from_loader("chip_smoke_parent", None))
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


def summary(fleet: dict) -> dict:
    """The walls and latencies of one phase's record, old and new layouts alike."""
    out = {"boot_s": fleet["boot_s"], "respawn_wall_s": fleet["respawn_wall_s"],
           "refresh_roll_s": fleet["refresh_roll_s"],
           "canary_roll_s": fleet["canary"]["good_roll_s"],
           "rollback_s": fleet["canary"]["rollback_s"],
           "tuning_roll_s": fleet["tuning"]["roll_s"],
           "latency_ms": {m: [v["p50_ms"], v["p95_ms"]] for m, v in fleet["latency"].items()}}
    return out


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="the other version's chip_smoke.py")
    ap.add_argument("--rounds", type=int, default=2, help="parent/change pairs")
    ap.add_argument("--out", default=os.path.join(REPO, "chip_smoke_out"))
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import chip_smoke as change
    import torch
    if not torch.cuda.is_available():
        print("fleet_phase_ab: no CUDA card", file=sys.stderr)
        return 1
    parent = load_parent(args.parent)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, torch.__version__, flush=True)
    port = change.load_port()
    port["build"].build_all()
    path = change.path_phase(torch, port, {}, card)
    order = []
    for r in range(args.rounds):
        order += [("parent", parent), ("change", change)] if r % 2 == 0 else \
                 [("change", change), ("parent", parent)]
    runs = []
    os.makedirs(args.out, exist_ok=True)
    for k, (side, mod) in enumerate(order):
        print(f"== {side} (run {k + 1} of {len(order)})", flush=True)
        details: dict = {}
        t = time.perf_counter()
        mod.fleet_phase(torch, port, path, details, card)
        runs.append({"side": side, "wall_s": time.perf_counter() - t,
                     **summary(details["fleet"])})
        with open(os.path.join(args.out, "fleet_phase_ab.json"), "w") as fh:
            json.dump({"card": card, "runs": runs}, fh, indent=1)
    for run in runs:
        print(json.dumps(run), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
