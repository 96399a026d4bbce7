"""Self-driving promotion: search the gate/knob space, verify exactness,
sign a tuning manifest.

The port's copy of ``tools/autotune.py``: the same control flow, arguments,
events and manifest, run without JAX::

    python -m data_diet_distributed_tpu_torch.tools.autotune --task score --method grand

The port's fast paths sit behind the JAX package's env gates (``DDT_GRAND_*``,
read by ``ops/grand_batched.py`` at import; ``DDT_SCORE_FETCH``, accepted and
inert in the port) and config knobs (``score.chunk_steps``,
``train.chunk_steps``, the prefetch depth).

1. **Enumerate** candidates from the pinned ``bisect_grand.py`` combos
   (``--full`` for the whole matrix, ``--combos`` for a subset), an
   ``allgather`` score-fetch arm, a chunk arm seeded by
   ``profile_dispatch.py``'s difference-quotient recommendation (run as a
   child), and, under ``--data-plane streaming``, prefetch-depth arms.
   Combos whose recorded per-combo ledger trail lost to the baseline combo's
   are pruned (negatives are remembered, not re-run).
2. **Measure** each in a child of this module (``--measure-child``) under
   the candidate's env: it builds ``--size`` synthetic examples from
   ``--seed`` and ``--seeds`` models from a ``torch.Generator``, warms up
   with one ``score_dataset`` pass (kernel build, graph capture), then times
   ``--repeats`` passes and reports the median examples × seeds / s (the
   train task: a chunked fit's steady ex/s). Its JSON line carries the
   kernel launches a batch, by kernel, from the port's launch counters, and
   it appends one ``perf_history`` record under a per-combo metric
   (``autotune.<name>.<metric>``) to ``--ledger`` (the port's own,
   ``artifacts/torch_perf_history.jsonl`` under the working directory), so
   ``perf_sentry.py`` defends each combo's own trail. This is the tuner's own
   measurement, not a benchmark.
3. **Verify**: the winning gated path is re-run in a child
   (``--verify-child``, env gates are read at import) on a seeded batch
   through ``score_dataset`` and compared against the toggle-independent
   ``grand_vmap`` method at the repo's pinned tolerances, in fp32 with TF32
   off. An inexact candidate is disqualified LOUDLY and the next-best takes
   its place — never a silent promotion.
4. **Sign**: the winner becomes an atomic, sha256-digest-signed manifest
   (``tuning.py``, backend ``cuda`` and the card's name) at ``--out``
   (default ``artifacts/tuning_manifest.json`` under the working directory,
   where ``cli`` run from there looks). A final confirmation child (headline
   metric, no combo prefix) appends the clean record the sentry judges.

Every decision is also appended to ``--events`` as ``{"kind":
"autotune_event"}`` records. ``--device`` (default ``cuda``) goes to every
child; without a card and without ``--device cpu`` the tool exits non-zero
before any child starts. Run card searches with ``--out``, ``--events`` and
``--ledger`` under an ignored directory (``chiprun_out/``).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

from ..tuning import (DEFAULT_MANIFEST_PATH, TuningError, build_tuning_manifest,
                      write_tuning_manifest)
from ..utils.io import atomic_append_jsonl
from .bisect_grand import COMBOS, FAST, _combo
from .perf_sentry import (CLEAN, DEFAULT_THRESHOLD, autotune_combo,
                          classify_record, load_ledger, lower_is_better, median)

#: The package's parent directory: put on a child's ``PYTHONPATH`` so
#: ``python -m`` finds the package from any working directory.
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEFAULT_LEDGER = os.path.join("artifacts", "torch_perf_history.jsonl")
DEFAULT_EVENTS = os.path.join("artifacts", "torch_autotune_events.jsonl")
#: The manifest's ``source``.
SOURCE = "data_diet_distributed_tpu_torch/tools/autotune.py"

#: Exactness pins — the tolerances every gated GraNd route is held to against
#: the vmap(grad) reference (the JAX tool's).
RTOL, ATOL = 2e-4, 1e-5

UNIT = "examples/sec/chip"


def _event(events_path: str | None, event: str, **fields) -> None:
    """One autotune_event record: printed (the tool's progress stream IS its
    log) and appended to the events JSONL."""
    rec = {"kind": "autotune_event", "ts": round(time.time(), 3),
           "event": event, **fields}
    print(f"[autotune] {json.dumps(rec)}", flush=True)
    if events_path:
        try:
            atomic_append_jsonl(events_path, rec)
        except OSError as exc:   # observability, best-effort
            print(f"[autotune] event append failed: {exc!r}",
                  file=sys.stderr, flush=True)


def device_error(device: str) -> str | None:
    """Why ``device`` cannot run here (a CUDA device asked for without a
    card), else None. Nothing falls back to the CPU."""
    import torch
    if device.startswith("cuda") and not torch.cuda.is_available():
        return ("CUDA is not available; pass --device cpu to run on the CPU "
                "(no fallback)")
    return None


def _child_env(env: dict) -> dict:
    """The environment of a child: ours, the candidate's gates, and the
    package on ``PYTHONPATH``."""
    out = {**os.environ, **env}
    out["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, os.environ.get("PYTHONPATH")) if p)
    return out


def _last_json(stdout: str) -> dict | None:
    lines = [ln for ln in stdout.splitlines() if ln.startswith("{")]
    if not lines:
        return None
    try:
        return json.loads(lines[-1])
    except ValueError:
        return {"error": f"unparseable child output: {lines[-1][:300]}"}


# ---------------------------------------------------------------------------
# enumeration


def ledger_negatives(records: list[dict], metric_tail: str,
                     threshold: float = DEFAULT_THRESHOLD) -> set[str]:
    """Combo names whose recorded per-combo trail already lost to the
    baseline combo's — a negative the search must remember, not re-run.

    Looks at clean ``autotune.<name>.<metric_tail>`` records; a combo with
    a median worse than baseline's median by more than ``threshold`` is a
    negative. No baseline trail → nothing is pruned (never prune blind)."""
    by_combo: dict[str, list[dict]] = {}
    for rec in records:
        combo = autotune_combo(rec)
        if (combo is not None and classify_record(rec) == CLEAN
                and str(rec.get("metric", "")).endswith("." + metric_tail)):
            by_combo.setdefault(combo, []).append(rec)
    base = by_combo.get("baseline")
    if not base:
        return set()
    base_med = median([float(r["value"]) for r in base])
    lower = lower_is_better(base[0])
    out = set()
    for name, rs in by_combo.items():
        if name == "baseline":
            continue
        m = median([float(r["value"]) for r in rs])
        worse = (m > base_med * (1 + threshold) if lower
                 else m < base_med * (1 - threshold))
        if worse:
            out.add(name)
    return out


def profile_chunk_recommendation(args) -> int | None:
    """Seed the chunk arm from ``profile_dispatch``'s difference-quotient
    recommendation (``recommended <label> >= N``), run as a child on
    ``--device``. Best-effort: a profiler failure skips the arm, it never
    fails the search."""
    cmd = [sys.executable, "-m", "data_diet_distributed_tpu_torch.tools.profile_dispatch",
           "--task", args.task, "--arch", args.arch, "--batch",
           str(args.batch), "--size", str(args.size), "--reps", "1",
           "--device", args.device]
    if args.task == "score":
        cmd += ["--method", args.method, "--grand-chunk",
                str(args.grand_chunk)]
    try:
        out = subprocess.run(cmd, env=_child_env({}), capture_output=True,
                             text=True, timeout=args.timeout)
    except subprocess.TimeoutExpired:
        return None
    m = None
    for line in out.stdout.splitlines():
        m = re.search(r"recommended \S+ >= (\d+)", line) or m
    return int(m.group(1)) if m else None


def enumerate_candidates(args, ledger_records: list[dict], metric_tail: str,
                         events_path: str | None = None) -> list[dict]:
    """The candidate list: ``{"name", "env", "extra"}`` per candidate.

    Seeded by the pinned bisect combos (FAST unless ``--full`` /
    ``--combos``), widened by the score-fetch arm, the profile-seeded chunk
    arm, and (streaming lane only) prefetch-depth arms; pruned by recorded
    ledger negatives."""
    if args.combos:
        wanted = [c.strip() for c in args.combos.split(",") if c.strip()]
        combos = [c for c in COMBOS if c[0] in wanted]
        missing = set(wanted) - {c[0] for c in combos}
        if missing:
            raise SystemExit(f"unknown --combos entries: {sorted(missing)} "
                             f"(known: {[c[0] for c in COMBOS]})")
    else:
        combos = [c for c in COMBOS if args.full or c[0] in FAST]
    cands = [{"name": n, "env": dict(e), "extra": list(x)}
             for n, e, x in combos]
    if args.task == "score" and not args.combos:
        # The JAX package's fetch engine knob: the port accepts it and scores
        # the same way, so this arm times the unchanged program.
        cands.append({"name": "allgather_fetch",
                      "env": {**_combo(), "DDT_SCORE_FETCH": "allgather"},
                      "extra": []})
    if not args.no_profile and not args.combos:
        rec = profile_chunk_recommendation(args)
        if rec is not None and rec > 1:
            _event(events_path, "profile_seed", chunk=rec)
            cands.append({"name": f"profile_chunk{rec}",
                          "env": _combo("STEM_XLA"),
                          "extra": ["--chunk", str(rec)]})
    if args.data_plane == "streaming" and not args.combos:
        for depth in (0, 2, 4):
            cands.append({"name": f"prefetch{depth}", "env": _combo(),
                          "extra": ["--data-plane", "streaming",
                                    "--prefetch-depth", str(depth)]})
    negatives = ledger_negatives(ledger_records, metric_tail,
                                 args.threshold)
    kept = []
    for cand in cands:
        if cand["name"] in negatives and cand["name"] != "baseline":
            _event(events_path, "pruned_negative", combo=cand["name"])
            continue
        kept.append(cand)
    return kept


# ---------------------------------------------------------------------------
# measurement


def _measure_cmd(args, cand: dict, *, combo_flag: bool) -> list[str]:
    cmd = [sys.executable, "-m", "data_diet_distributed_tpu_torch.tools.autotune",
           "--measure-child", "--task", args.task,
           "--method", args.method, "--arch", args.arch,
           "--dataset", args.dataset, "--size", str(args.size),
           "--batch", str(args.batch), "--grand-chunk",
           str(args.grand_chunk), "--repeats", str(args.repeats),
           "--seeds", str(args.seeds), "--ledger", args.ledger,
           "--device", args.device]
    if combo_flag:
        cmd += ["--autotune-combo", cand["name"]]
    return cmd + list(cand["extra"])


def measure_candidate(args, cand: dict, events_path: str | None = None, *,
                      combo_flag: bool = True) -> dict:
    """One measure child under the candidate's pinned env. Returns the
    child's JSON line (or an error dict); the ledger append happened inside
    the child."""
    cmd = _measure_cmd(args, cand, combo_flag=combo_flag)
    try:
        out = subprocess.run(cmd, env=_child_env(cand["env"]),
                             capture_output=True, text=True,
                             timeout=args.timeout)
    except subprocess.TimeoutExpired:
        return {"error": "TIMEOUT"}
    line = _last_json(out.stdout)
    return line if line is not None else {
        "error": (out.stderr or "no measure output")[-300:]}


def _launches_per_batch(counts: dict, batches: int) -> dict:
    return {k: v / batches for k, v in sorted(counts.items())}


def _score_rate(args, device) -> dict:
    """The score task: ``--repeats`` timed ``score_dataset`` passes after one
    warm-up pass, all sharing one ``GraphCache`` (the warm-up captures, the
    timed passes replay)."""
    import torch

    from ..data.datasets import load_dataset
    from ..data.pipeline import num_batches
    from ..graphs import GraphCache
    from ..models import create_model
    from ..ops import kernels
    from ..ops.scoring import score_dataset
    from ..weights import init_variables

    ds, _ = load_dataset(args.dataset, synthetic_size=args.size, seed=args.seed)
    stem = "imagenet" if args.dataset == "synthetic_imagenet" else "cifar"
    model = create_model(args.arch, ds.num_classes, half_precision=True, stem=stem)
    seeds = [init_variables(args.arch, args.seed + s, device, num_classes=ds.num_classes,
                            stem=stem) for s in range(args.seeds)]
    graphs = GraphCache()
    kw = dict(method=args.method, batch_size=args.batch, chunk=args.grand_chunk,
              device=device, chunk_steps=args.chunk, data_plane=args.data_plane,
              prefetch_depth=args.prefetch_depth, graphs=graphs)
    try:
        t0 = time.perf_counter()
        score_dataset(model, seeds, ds, **kw)
        warmup_s = time.perf_counter() - t0
        kernels.reset_launch_counts()
        passes = []
        for _ in range(args.repeats):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            scores = score_dataset(model, seeds, ds, **kw)
            passes.append(time.perf_counter() - t0)
        counts = kernels.launch_counts()
        # The chunk K the passes ran: the longest captured block (1: per batch).
        k_chunk = max((key[2] for key in graphs.programs), default=1)
    finally:
        graphs.release()
    nb = num_batches(len(ds), args.batch)
    rates = [len(ds) * len(seeds) / s for s in passes]
    return {"value": round(statistics.median(rates), 1),
            "pass_s": [round(s, 4) for s in passes], "warmup_s": round(warmup_s, 3),
            "chunk_steps": k_chunk,
            "finite": bool(np.isfinite(scores).all()),
            "launches_per_batch": _launches_per_batch(
                counts, nb * len(seeds) * args.repeats)}


def _train_rate(args, device) -> dict:
    """The train task: a fit of ``1 + --repeats`` epochs; the value is the
    median of the steady epochs' ex/s (epoch 0 holds the captures)."""
    from ..config import load_config
    from ..data.datasets import load_dataset
    from ..ops import kernels
    from ..train.loop import fit

    over = [f"data.dataset={args.dataset}", f"data.synthetic_size={args.size}",
            f"data.batch_size={args.batch}", f"model.arch={args.arch}",
            f"train.seed={args.seed}", f"train.num_epochs={1 + args.repeats}",
            "train.log_every_steps=100000", f"data.data_plane={args.data_plane}",
            f"data.prefetch_depth={args.prefetch_depth}"]
    if args.dataset == "synthetic_imagenet":
        over += ["model.stem=imagenet", "model.num_classes=100"]
    if args.chunk is not None:
        over.append(f"train.chunk_steps={args.chunk}")
    cfg = load_config(None, over)
    train_ds, _ = load_dataset(args.dataset, synthetic_size=args.size, seed=args.seed)
    kernels.reset_launch_counts()
    result = fit(cfg, train_ds, None, device=device)
    steady = [h["examples_per_s"] for h in result.history[1:]]
    steps = -(-len(train_ds) // args.batch) * len(result.history)
    return {"value": round(statistics.median(steady), 1),
            "epoch_s": [round(h["epoch_s"], 4) for h in result.history],
            "chunk_steps": result.chunk_steps, "finite": True,
            "launches_per_batch": _launches_per_batch(kernels.launch_counts(), steps)}


def _measure_child(args) -> int:
    """Runs WITH the candidate env already in place: one measurement, one JSON
    line on stdout, one ledger record."""
    from ..cli import _hardware
    from ..device import resolve_device

    metric = (f"{args.method}_scoring_examples_per_sec_per_chip"
              if args.task == "score" else "train_examples_per_sec_per_chip")
    if args.autotune_combo:
        # Candidate runs are their own per-combo metric (= their own sentry
        # group): a sweep must not pollute the headline trail.
        metric = f"autotune.{args.autotune_combo}.{metric}"
    geometry = {"task": args.task, "arch": args.arch, "dataset": args.dataset,
                "size": args.size, "batch": args.batch, "method": args.method,
                "seeds": args.seeds}
    if args.data_plane != "auto":
        geometry["data_plane"] = args.data_plane
        if args.data_plane == "streaming":
            geometry["prefetch_depth"] = args.prefetch_depth
    line = {"metric": metric, "unit": UNIT}
    try:
        device = resolve_device(args.device)
        line["backend"], line["device_kind"] = _hardware(device)
        line["n_devices"] = 1
        line.update(_score_rate(args, device) if args.task == "score"
                    else _train_rate(args, device))
        if not line["finite"]:
            line["error"] = "non-finite scores"
    except Exception as exc:   # noqa: BLE001 — the line reports every failure
        line.update(value=0.0, error=f"{type(exc).__name__}: {exc}"[-300:])
    line["exit_class"] = "error" if line.get("error") else "ok"
    if args.autotune_combo:
        line["autotune"] = {"combo": args.autotune_combo}
    print(json.dumps(line), flush=True)
    if args.ledger:
        rec = {"kind": "perf_history", "ts": round(time.time(), 3),
               "source": "autotune", "geometry": geometry}
        for k in ("metric", "value", "unit", "error", "exit_class", "backend",
                  "device_kind", "n_devices", "chunk_steps", "launches_per_batch",
                  "autotune"):
            if line.get(k) is not None:
                rec[k] = line[k]
        try:
            atomic_append_jsonl(args.ledger, rec)
        except OSError as exc:   # the ledger is observability
            print(f"[autotune] perf ledger append failed: {exc!r}",
                  file=sys.stderr, flush=True)
    return 0 if line["exit_class"] == "ok" else 1


# ---------------------------------------------------------------------------
# exactness verification


def verify_candidate(args, cand: dict, events_path: str | None = None,
                     runner=None) -> dict:
    """Re-run this module in ``--verify-child`` mode under the candidate's env
    (the gates are read at ops import) and compare the production scoring
    path against the toggle-independent vmap(grad) reference at the pinned
    tolerances. Returns the child's report dict; ``ok`` False disqualifies.

    ``runner`` is injectable for tests (same signature as the default)."""
    if runner is None:
        def runner(cand):
            cmd = [sys.executable, "-m", "data_diet_distributed_tpu_torch.tools.autotune",
                   "--verify-child", "--arch", args.arch,
                   "--method", args.method,
                   "--verify-batch", str(args.verify_batch),
                   "--grand-chunk", str(min(args.grand_chunk, 4)),
                   "--device", args.device]
            if "--chunk" in cand["extra"]:
                i = cand["extra"].index("--chunk")
                cmd += ["--chunk", cand["extra"][i + 1]]
            try:
                out = subprocess.run(cmd, env=_child_env(cand["env"]),
                                     capture_output=True, text=True,
                                     timeout=args.timeout)
            except subprocess.TimeoutExpired:
                return {"ok": False, "error": "TIMEOUT"}
            report = _last_json(out.stdout)
            if report is None:
                return {"ok": False, "error": (out.stderr or "no output")[-300:]}
            report.setdefault("ok", False)
            return report
    report = runner(cand)
    report.setdefault("combo", cand["name"])
    if report.get("ok"):
        _event(events_path, "verified", combo=cand["name"],
               max_abs_err=report.get("max_abs_err"))
    else:
        # LOUD disqualification: an inexact fast path must never be
        # recommended — this is the promotion gate, not a warning.
        _event(events_path, "disqualified", combo=cand["name"],
               error=report.get("error"),
               max_abs_err=report.get("max_abs_err"))
    return report


def _verify_child(args) -> int:
    """Runs WITH the candidate env already in place: scores a seeded batch
    through the production path (``score_dataset``, the kernels on the card)
    in fp32 with TF32 off, and checks it against the ``grand_vmap``
    reference."""
    from ..cli import _hardware
    from ..data.datasets import ArrayDataset
    from ..device import resolve_device, set_parity_mode
    from ..models import create_model
    from ..ops.scoring import score_dataset
    from ..weights import init_variables

    device = resolve_device(args.device)
    if device.type == "cuda":
        set_parity_mode(True)
    b, hw = args.verify_batch, 16
    rng = np.random.default_rng(0)
    ds = ArrayDataset(rng.normal(size=(b, hw, hw, 3)).astype(np.float32),
                      rng.integers(0, 10, b).astype(np.int32),
                      np.arange(b, dtype=np.int32), 10)
    model = create_model(args.arch, 10)
    variables = init_variables(args.arch, 0, device)
    kw = dict(batch_size=b, device=device)
    scores = score_dataset(model, [variables], ds, method=args.method,
                           chunk=args.grand_chunk, chunk_steps=args.chunk, **kw)
    if os.environ.get("DDT_AUTOTUNE_FAKE_INEXACT"):
        scores = scores + 0.01   # test hook: simulate a wrong fast path
    backend, device_kind = _hardware(device)
    report = {"backend": backend, "device_kind": device_kind, "n_devices": 1}
    if args.method in ("grand", "grand_vmap"):
        ref = score_dataset(model, [variables], ds, method="grand_vmap",
                            chunk=max(2, min(args.grand_chunk, b)), **kw)
        err = np.abs(scores - ref)
        denom = np.maximum(np.abs(ref), 1e-12)
        report["max_abs_err"] = float(err.max())
        report["ok"] = bool(np.all(err <= ATOL + RTOL * np.abs(ref))
                            and np.isfinite(scores).all())
        report["max_rel_err"] = float((err / denom).max())
        report["rtol"], report["atol"] = RTOL, ATOL
        report["reference"] = "grand_vmap"
    else:
        # Non-grand methods have no env-gated fast path to diverge; pin
        # finiteness + shape so a broken candidate still fails loudly.
        report["ok"] = bool(np.isfinite(scores).all()
                            and scores.shape == (b,))
        report["reference"] = "finite-check"
    print(json.dumps(report), flush=True)
    return 0 if report["ok"] else 1


# ---------------------------------------------------------------------------
# manifest assembly


def _manifest_config_knobs(args, cand: dict) -> dict:
    cfg: dict = {}
    extra = list(cand["extra"])
    if "--chunk" in extra:
        chunk = int(extra[extra.index("--chunk") + 1])
        key = "score.chunk_steps" if args.task == "score" else \
            "train.chunk_steps"
        cfg[key] = chunk
    if "--prefetch-depth" in extra:
        cfg["data.prefetch_depth"] = int(
            extra[extra.index("--prefetch-depth") + 1])
    if "--data-plane" in extra:
        cfg["data.data_plane"] = extra[extra.index("--data-plane") + 1]
    return cfg


# ---------------------------------------------------------------------------
# main


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", default="score", choices=["score", "train"])
    ap.add_argument("--method", default="grand")
    ap.add_argument("--arch", default="resnet18")
    ap.add_argument("--dataset", default="synthetic")
    ap.add_argument("--size", type=int, default=8192)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--grand-chunk", type=int, default=64)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seeds", type=int, default=2,
                    help="scoring seeds a measured pass (examples x seeds / s)")
    ap.add_argument("--seed", type=int, default=0,
                    help="the synthetic data's seed and the first model seed")
    ap.add_argument("--data-plane", default="auto")
    ap.add_argument("--prefetch-depth", type=int, default=2,
                    help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, for every child")
    ap.add_argument("--timeout", type=int, default=900,
                    help="per-subprocess wall cap (measure / profile / verify)")
    ap.add_argument("--full", action="store_true",
                    help="the whole bisect matrix, not the curated FAST race")
    ap.add_argument("--combos", default=None,
                    help="comma-separated explicit bisect-combo subset "
                         "(disables the fetch/profile/prefetch arms)")
    ap.add_argument("--no-profile", action="store_true",
                    help="skip the profile_dispatch-seeded chunk arm")
    ap.add_argument("--threshold", type=float, default=DEFAULT_THRESHOLD,
                    help="ledger-negative pruning threshold")
    ap.add_argument("--ledger", default=DEFAULT_LEDGER,
                    help="perf_history JSONL the measure children append to "
                         "('' disables)")
    ap.add_argument("--events", default=DEFAULT_EVENTS,
                    help="autotune_event JSONL sink ('' disables)")
    ap.add_argument("--out", default=DEFAULT_MANIFEST_PATH)
    ap.add_argument("--no-confirm", action="store_true",
                    help="skip the final headline-metric confirmation child")
    # internal: the children (env gates already pinned by the parent)
    ap.add_argument("--measure-child", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--autotune-combo", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--verify-child", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--verify-batch", type=int, default=8,
                    help=argparse.SUPPRESS)
    ap.add_argument("--chunk", type=int, default=None,
                    help=argparse.SUPPRESS)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.verify_child:
        return _verify_child(args)
    if args.measure_child:
        return _measure_child(args)
    err = device_error(args.device)
    if err:
        print(f"[autotune] {err}", file=sys.stderr, flush=True)
        return 2
    events = args.events or None
    metric_tail = (f"{args.method}_scoring_examples_per_sec_per_chip"
                   if args.task == "score" else
                   "train_examples_per_sec_per_chip")
    ledger_records = (load_ledger(args.ledger)
                      if args.ledger and os.path.exists(args.ledger) else [])
    cands = enumerate_candidates(args, ledger_records, metric_tail, events)
    if not any(c["name"] == "baseline" for c in cands):
        # The all-off program is the search's reference point AND the
        # guaranteed-exact fallback; it is never pruned away.
        cands.insert(0, {"name": "baseline", "env": _combo(), "extra": []})
    _event(events, "search_start", task=args.task, method=args.method,
           arch=args.arch, dataset=args.dataset, size=args.size,
           batch=args.batch, candidates=[c["name"] for c in cands])

    results = []
    for cand in cands:
        line = measure_candidate(args, cand, events)
        rec = {**cand, "result": line}
        results.append(rec)
        err = line.get("error")
        value = line.get("value")
        _event(events, "measured", combo=cand["name"], value=value,
               unit=line.get("unit"), error=err)
        if err and "backend" in str(err):
            # A missing card fails every combo identically — one bounded
            # failure is the signal.
            _event(events, "abort_backend", combo=cand["name"], error=err)
            return 2

    clean = [r for r in results
             if not r["result"].get("error")
             and (r["result"].get("value") or 0) > 0
             and r["result"].get("exit_class", "ok") == "ok"]
    if not clean:
        _event(events, "no_clean_candidates")
        return 2
    lower = str(clean[0]["result"].get("unit", "")).lower() in (
        "seconds", "s", "ms")
    ranked = sorted(clean, key=lambda r: r["result"]["value"],
                    reverse=not lower)

    winner, exactness = None, []
    for cand in ranked:
        report = verify_candidate(args, cand, events)
        exactness.append({k: report.get(k) for k in
                          ("combo", "ok", "reference", "max_abs_err",
                           "max_rel_err", "rtol", "atol")})
        if report.get("ok"):
            winner = {**cand, "verify": report}
            break
    if winner is None:
        _event(events, "no_exact_candidate")
        return 2
    _event(events, "winner", combo=winner["name"],
           value=winner["result"]["value"],
           unit=winner["result"].get("unit"))

    baseline = next((r for r in results if r["name"] == "baseline"), None)
    baseline_value = (baseline["result"].get("value")
                      if baseline and not baseline["result"].get("error")
                      else None)
    manifest = build_tuning_manifest(
        task=args.task, method=args.method, arch=args.arch,
        dataset=args.dataset, batch_size=args.batch,
        backend=winner["verify"].get("backend", "unknown"),
        device_kind=winner["verify"].get("device_kind", "unknown"),
        n_devices=int(winner["verify"].get("n_devices", 1)),
        env=winner["env"], config=_manifest_config_knobs(args, winner),
        chosen_combo=winner["name"],
        metric=str(winner["result"].get("metric", metric_tail)),
        value=float(winner["result"]["value"]),
        unit=str(winner["result"].get("unit", "")),
        baseline_value=baseline_value, exactness=exactness,
        candidates_considered=len(results), source=SOURCE)
    write_tuning_manifest(args.out, manifest)
    _event(events, "manifest_written", path=args.out,
           digest=manifest["digest"], combo=winner["name"])

    if not args.no_confirm:
        # The headline-metric confirmation: the tuned point's clean record
        # lands LAST in the ledger, so perf_sentry judges the promoted
        # configuration (and defends it next round).
        line = measure_candidate(args, winner, events, combo_flag=False)
        _event(events, "confirmed", combo=winner["name"],
               value=line.get("value"), error=line.get("error"))
        if line.get("error"):
            print("[autotune] confirmation run failed — manifest stands, "
                  "but the headline trail gained no clean record",
                  file=sys.stderr, flush=True)
            return 3
    print(json.dumps({"manifest": args.out, "digest": manifest["digest"],
                      "chosen_combo": winner["name"],
                      "value": winner["result"]["value"],
                      "baseline_value": baseline_value}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        raise SystemExit(main())
    except TuningError as err:
        print(f"[autotune] {err}", file=sys.stderr, flush=True)
        raise SystemExit(2)
