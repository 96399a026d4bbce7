"""ImageNet-scale soak driver: ingestion benchmark AND fault-injecting
long-haul soak.

The port's copy of ``tools/imagenet_soak.py``: the same modes, arguments,
fault schedules, records and final JSON line, run without JAX, with
``--device cuda|cpu`` (default ``cuda``) in place of the JAX backends. Without
a card and without ``--device cpu`` the tool exits non-zero before it writes
anything; every child gets the same ``--device``, and nothing falls back to
the CPU.

**Soak mode** (``--soak`` / ``--smoke``) runs the port's CLI under
``resilience/elastic.py::ElasticSupervisor`` for a schedule of injected
faults (SIGTERM preemptions, rank-targeted SIGKILL host kills, NaN losses,
hang stalls, host rejoins, torn shard reads), one fault per cycle. Each cycle
is judged by ``python -m data_diet_distributed_tpu_torch.tools.run_monitor
--once`` (0 healthy / 1 SLO-violated / 2 unreachable-or-stale), the SLO
engine's verdict in the terminal ``run_summary``, the stream's schema
(``tools/validate_metrics.py``) and ``obs/postmortem.py``'s whole-lineage
verdict (every recovery's chain must be explained by the records it left).
The driver emits one ``{"kind": "soak_report"}`` record (and prints it as
the final JSON line); exit 0 iff every cycle recovered and every monitor
verdict was healthy.

* ``--smoke``: the bounded mode, single-host, schedule ``sigterm,nan,kill``
  (``--data-plane streaming``: ``torn,kill``) over a tiny synthetic
  ``train`` workload.
* ``--soak``: the long-haul mode: ``run`` pipeline cycles at ``--world``
  processes with the full ``sigterm,nan,kill,rejoin,hang,none`` schedule on
  ``--rows``-scale ImageNet-geometry ``.npy`` data.

**Ingestion mode** (the default) runs BASELINE config 5's geometry
(ResNet-50, 96x96 images, 100 classes, >= 200k rows) through the
memory-mapped ``.npy`` pipeline and measures:

* **ingestion throughput**: one full epoch of production batch assembly
  over the mmap: the host gather (``data/native.py``) with lazy uint8
  normalization, uploaded to the device by the streaming plane
  (``data/pipeline.py::prefetch_stream``: pinned buffers, a copy stream);
* **scoring rate**: ``--score-method`` through ``ops/scoring.py::score_dataset``
  on ``--score-rows`` rows (0 = the whole train split), streamed, after one
  warm-up batch (kernel builds);
* **host-RSS bound**: peak ANONYMOUS memory during the epoch and the scoring
  pass, which must stay O(batch), not O(dataset): ``/proc/self/status``
  RssAnon as the JAX tool reads it or, on a kernel without that line, the
  ``Anonymous:`` lines of ``/proc/self/smaps_rollup`` or ``smaps`` (the
  source is printed on stderr; NaN without any). File-backed mmap pages are
  reclaimable page cache and excluded by design.

The dataset is synthetic-imagenet (class templates + noise) quantized to
uint8 and written CHUNKED straight into the ``{split}_images.npy`` layout with
``stats.npz``: the 5.5 GB train split never exists as float32 in RAM.
``generate`` writes the JAX tool's bytes for the same arguments. A ResNet
scores with the ImageNet stem; an arch without one (``tiny_cnn``) with its
own.

CPU::

    python -m data_diet_distributed_tpu_torch.tools.imagenet_soak --device cpu \\
        --rows 200000 --score-rows 2048

Card::

    python -m data_diet_distributed_tpu_torch.tools.imagenet_soak --rows 200000 --score-rows 0
    python -m data_diet_distributed_tpu_torch.tools.imagenet_soak --smoke --workdir /tmp/ddt_soak

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

from .autotune import _child_env, device_error
from .validate_metrics import validate_file


#: Where the anonymous resident set is read, in order: the JAX tool's
#: ``RssAnon`` line, then the ``Anonymous:`` lines of the smaps files (a
#: kernel whose status has no ``RssAnon`` may still account them there).
#: File-backed pages (the mmap) are in none of them.
RSS_SOURCES = (("/proc/self/status", "RssAnon:"),
               ("/proc/self/smaps_rollup", "Anonymous:"),
               ("/proc/self/smaps", "Anonymous:"))


def rss_anon_source() -> tuple[str, str] | None:
    """The first of ``RSS_SOURCES`` this host has."""
    for path, field in RSS_SOURCES:
        try:
            with open(path) as fh:
                if any(line.startswith(field) for line in fh):
                    return path, field
        except OSError:
            continue
    return None


def rss_anon_mb(source: tuple[str, str] | None) -> float:
    """The anonymous resident set in MB: ``source``'s field lines summed;
    NaN without them."""
    if source is None:
        return float("nan")
    path, field = source
    kb, seen = 0, False
    try:
        with open(path) as fh:
            for line in fh:
                if line.startswith(field):
                    kb += int(line.split()[1])
                    seen = True
    except OSError:
        return float("nan")
    return kb / 1024.0 if seen else float("nan")


def generate(data_dir: str, rows: int, image_size: int, classes: int,
             seed: int, chunk: int = 8192) -> float:
    """Write {train,test}_images.npy (uint8) + labels + stats.npz, chunked."""
    os.makedirs(data_dir, exist_ok=True)
    t0 = time.perf_counter()
    template_rng = np.random.default_rng(np.random.SeedSequence([seed, 0xD1E7]))
    templates = template_rng.normal(
        0.0, 0.5, size=(classes, image_size, image_size, 3)).astype(np.float32)
    channel_sig = template_rng.normal(
        0.0, 1.0, size=(classes, 1, 1, 3)).astype(np.float32)

    s = np.zeros(3, np.float64)
    s2 = np.zeros(3, np.float64)
    npix = 0
    for split, n in (("train", rows), ("test", max(rows // 20, classes))):
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, 1 if split == "train" else 2]))
        labels = rng.integers(0, classes, size=n).astype(np.int32)
        out = np.lib.format.open_memmap(
            os.path.join(data_dir, f"{split}_images.npy"), mode="w+",
            dtype=np.uint8, shape=(n, image_size, image_size, 3))
        for i in range(0, n, chunk):
            lab = labels[i:i + chunk]
            x = (templates[lab] + channel_sig[lab]
                 + rng.normal(0.0, 0.4, size=(len(lab), image_size, image_size,
                                              3)).astype(np.float32))
            # Quantize the ~N(0, 0.8) float field into uint8 with headroom.
            u8 = np.clip(np.rint(x * 48.0 + 128.0), 0, 255).astype(np.uint8)
            out[i:i + chunk] = u8
            if split == "train":
                c = u8.astype(np.float64) / 255.0
                s += c.sum(axis=(0, 1, 2))
                s2 += np.square(c).sum(axis=(0, 1, 2))
                npix += c.shape[0] * c.shape[1] * c.shape[2]
        out.flush()
        del out
        np.save(os.path.join(data_dir, f"{split}_labels.npy"), labels)
    mean = s / npix
    std = np.sqrt(np.maximum(s2 / npix - mean**2, 0.0)) + 1e-8
    np.savez(os.path.join(data_dir, "stats.npz"),
             mean=mean.astype(np.float32), std=std.astype(np.float32))
    return time.perf_counter() - t0


# --------------------------------------------------------------- soak mode

#: fault name -> DDT_FAULT_PLAN payload (rank-targeted at world > 1 so the
#: drill kills a NON-primary host while rank 0 survives to tell the story).
#: Coordinates assume the cycle workloads below (checkpoint_every=1, >= 2
#: epochs): every fault lands after at least one durable step exists.
FAULTS = {
    "none": None,
    "sigterm": {"sigterm_at_epoch_end": 0},
    # Kill after epoch 1, not 0: epoch 0's checkpoint promotion then has a
    # whole epoch to land, so the relaunch exercises a real tier RESTORE.
    "kill": {"kill_rank_after_epoch": 1},
    "nan": {"nan_loss_at_epoch": 1},
    "hang": {"hang_at": 3, "hang_seconds": 600.0},
    "rejoin": {"rejoin_after_stage": "score"},
    # Storage fault (needs --data-plane streaming): persistent torn reads of
    # one mid-range train shard — the digest check quarantines it, the pass
    # aborts with a typed ShardReadError, and the supervisor's relaunch
    # (fault_env disarms the plan at attempt > 0) reads it clean.
    "torn": {"torn_shard_read": 3},
}

SMOKE_SCHEDULE = "sigterm,nan,kill"
#: The elastic×streaming smoke: the torn-shard storage cycle PLUS a SIGKILL
#: with the streaming plane active (prefetch threads must not outlive the
#: kill; the relaunch restores and streams clean).
SMOKE_STREAMING_SCHEDULE = "torn,kill"
SOAK_SCHEDULE = "sigterm,nan,kill,rejoin,hang,none"


def _ensure_smoke_shards(workdir: str) -> str:
    """The streaming smoke's dataset: the tiny synthetic train workload
    converted ONCE into the sharded on-disk format (8 train shards of 16
    rows), shared read-only by every cycle."""
    from ..data import sharded
    from ..data.datasets import _synthetic
    shard_dir = os.path.join(workdir, "shards")
    if sharded.is_sharded_dir(shard_dir) \
            and not sharded.verify_manifest(shard_dir):
        return shard_dir
    train_x, train_y = _synthetic(128, 10, 0, "train", 32)
    test_x, test_y = _synthetic(32, 10, 0, "test", 32)
    splits = {
        "train": sharded.write_split(shard_dir, "train", train_x, train_y,
                                     shard_size=16),
        "test": sharded.write_split(shard_dir, "test", test_x, test_y,
                                    shard_size=16),
    }
    sharded.write_manifest(shard_dir, splits, 10, None)
    return shard_dir


def _cycle_overrides(args, cycle_dir: str, fault: str) -> list[str]:
    """The cycle's CLI overrides — a real production invocation, tiny in
    smoke mode, ``--rows``-scale otherwise."""
    ckpt = os.path.join(cycle_dir, "ckpt")
    over = [
        f"train.checkpoint_dir={ckpt}",
        f"obs.metrics_path={os.path.join(cycle_dir, 'metrics.jsonl')}",
        "train.checkpoint_every=1", "train.log_every_steps=1000",
        "train.half_precision=false",
        # The multi-tier path IS the elastic restore story: fast local
        # saves, digest-verified promotion, restorable at any world size.
        "checkpoint.local_tier=true",
        # Watchdog + SLO engine armed: a hang cycle must convert to a
        # retriable failure, and every run_summary must carry an SLO
        # verdict for the report.
        f"resilience.step_timeout_s={args.step_timeout}",
        f"obs.slo_heartbeat_stale_s={max(30.0, 2 * args.step_timeout)}",
        # In-process recovery for faults that don't kill the process (NaN
        # rollback, watchdog timeout) — the supervisor covers the rest.
        "train.auto_resume_retries=1",
        # Elastic supervision (children read these too: stage barriers).
        "elastic.enabled=true",
        f"elastic.world={args.world}",
        # Strictly above the starting world: a rejoin cycle must have room
        # to GROW, or the injected join is denied and the drill proves
        # nothing.
        f"elastic.max_world={max(args.world + 1, 2)}",
        "elastic.backoff_s=0.2",
        f"elastic.reap_timeout_s={max(20.0, 2 * args.step_timeout)}",
        f"elastic.heartbeat_stale_s={max(20.0, 2 * args.step_timeout)}",
        f"elastic.max_restarts={args.max_restarts}",
    ]
    if args.smoke:
        over += [
            "data.batch_size=64", "data.eval_batch_size=64",
            "model.arch=tiny_cnn", "optim.lr=0.05", "train.num_epochs=3",
            "score.pretrain_epochs=0", "score.batch_size=64",
        ]
        if args.data_plane == "streaming":
            # The elastic×streaming lane: same tiny workload, fed from the
            # digest-verified shard store through the prefetch plane.
            over += [
                "data.dataset=sharded",
                f"data.data_dir={os.path.join(args.workdir, 'shards')}",
                "data.data_plane=streaming",
                "data.read_backoff_s=0.01",
            ]
        else:
            over += ["data.dataset=synthetic", "data.synthetic_size=128"]
    else:
        over += [
            "data.dataset=npz", f"data.data_dir={args.data_dir}",
            f"data.batch_size={args.batch}", f"model.arch={args.arch}",
            "model.stem=imagenet", f"train.num_epochs={args.epochs}",
            "prune.sparsity=0.5", "score.pretrain_epochs=1",
            f"score.method={args.score_method}",
        ]
    return over


def _last_json(stdout: str, what: str) -> dict:
    try:
        return json.loads(stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        return {"error": f"unparseable {what} output: {stdout[-200:]}"}


def _judge_cycle(cycle_dir: str) -> dict:
    """``run_monitor --once --json`` over the cycle's metrics stream (files
    mode: a finished run is judged by its records), the stream's schema
    validation, AND the postmortem engine's whole-lineage verdict
    (``obs/postmortem.py`` — every recovery's chain must be explained by
    the records it left) — the soak's per-cycle verdict."""
    metrics = os.path.join(cycle_dir, "metrics.jsonl")
    env = _child_env({})
    proc = subprocess.run(
        [sys.executable, "-m", "data_diet_distributed_tpu_torch.tools.run_monitor",
         "--metrics", metrics, "--once", "--json"],
        capture_output=True, text=True, timeout=60, env=env)
    view = _last_json(proc.stdout, "monitor")
    try:
        problems = validate_file(metrics)
    except OSError as err:
        problems = [f"{metrics}: unreadable ({err})"]
    pm = subprocess.run(
        [sys.executable, "-m", "data_diet_distributed_tpu_torch.obs.postmortem",
         cycle_dir, "--json"],
        capture_output=True, text=True, timeout=60, env=env)
    pm_report = _last_json(pm.stdout, "postmortem")
    if "error" in pm_report:
        pm_report = {"problems": [pm_report["error"]]}
    summary = view.get("run_summary") or {}
    return {
        "monitor_exit": proc.returncode,
        "exit_class": summary.get("exit_class"),
        "slo": summary.get("slo"),
        "violations": len(view.get("violations") or []),
        "stream_problems": problems[:5],
        "postmortem_exit": pm.returncode,
        "postmortem": {
            "run_id": pm_report.get("run_id"),
            "attempts": pm_report.get("attempts"),
            # The chain list, verbatim — this block is re-emitted under the
            # same `postmortem_report` kind the postmortem itself uses, and
            # one registered kind must mean ONE shape (`recoveries` is a
            # list of chains, never a count).
            "recoveries": pm_report.get("recoveries") or [],
            "recovery_walls_s": [c.get("recovery_wall_s")
                                 for c in pm_report.get("recoveries") or []],
            "lost_wall_s": pm_report.get("lost_wall_s"),
            "ok": pm_report.get("ok"),
            "problems": (pm_report.get("problems") or [])[:5],
        },
    }


def _have_data(data_dir: str) -> bool:
    return all(os.path.exists(os.path.join(data_dir, f))
               for f in ("train_images.npy", "train_labels.npy",
                         "test_images.npy", "test_labels.npy", "stats.npz"))


def soak_main(args) -> int:
    from ..config import load_config
    from ..resilience.elastic import ElasticSupervisor, JsonlLogger

    if not args.smoke and not _have_data(args.data_dir):
        # Long-haul cycles run the ImageNet-geometry npy workload; generate
        # it once (chunked, uint8 — never float32-resident) when absent,
        # exactly like the ingestion mode.
        generate(args.data_dir, args.rows, args.image_size, args.classes, args.seed)
    default_schedule = (SOAK_SCHEDULE if not args.smoke
                        else SMOKE_STREAMING_SCHEDULE
                        if args.data_plane == "streaming"
                        else SMOKE_SCHEDULE)
    schedule = [f.strip() for f in
                (args.schedule or default_schedule).split(",") if f.strip()]
    unknown = [f for f in schedule if f not in FAULTS]
    if unknown:
        raise SystemExit(f"unknown fault(s) {unknown}; known: "
                         f"{sorted(FAULTS)}")
    if args.cycles:
        schedule = (schedule * args.cycles)[: args.cycles]
    os.makedirs(args.workdir, exist_ok=True)
    if args.smoke and args.data_plane == "streaming":
        _ensure_smoke_shards(args.workdir)
    driver_log = JsonlLogger(os.path.join(args.workdir, "soak.jsonl"),
                             echo=not args.quiet)
    t0 = time.perf_counter()
    cycles = []
    deadline = (time.monotonic() + args.duration) if args.duration else None
    for i, fault in enumerate(schedule):
        if deadline is not None and time.monotonic() > deadline:
            break
        cycle_dir = os.path.join(args.workdir, f"cycle{i}_{fault}")
        os.makedirs(cycle_dir, exist_ok=True)
        overrides = _cycle_overrides(args, cycle_dir, fault)
        cfg = load_config(None, overrides)
        plan = FAULTS[fault]
        if plan is not None and args.world > 1:
            plan = dict(plan, rank=1)   # kill/stall a NON-primary host

        def fault_env(attempt: int, plan=plan):
            # Attempt 0 only: a relaunched attempt must not re-trip the
            # fault it is recovering from (exact-coordinate plans can
            # re-fire when resume replays the faulted unit).
            if attempt == 0 and plan is not None:
                return {"DDT_FAULT_PLAN": json.dumps(plan)}
            return {"DDT_FAULT_PLAN": ""}

        cycle_log = JsonlLogger(cfg.obs.metrics_path, echo=False)
        supervisor = ElasticSupervisor(
            cfg, args.command, overrides=overrides, logger=cycle_log,
            fault_env=fault_env, device=args.device)
        c0 = time.perf_counter()
        try:
            rc = supervisor.run()
        finally:
            cycle_log.close()
        wall = round(time.perf_counter() - c0, 1)
        verdict = _judge_cycle(cycle_dir)
        rec = {
            "cycle": i, "fault": fault, "supervisor_rc": rc,
            "attempts": supervisor.attempt + 1,
            "final_world": supervisor.world, "wall_s": wall,
            "elastic_events": [e["event"] for e in supervisor.events],
            **verdict,
        }
        rec["recovered"] = bool(rc == 0 and verdict["monitor_exit"] == 0
                                and verdict["postmortem_exit"] == 0
                                and not verdict["stream_problems"])
        cycles.append(rec)
        driver_log.log("elastic_event", event="soak_cycle", **rec)
        # The forensics verdict as its own schema-registered record — the
        # soak stream is where a long-haul report's reader looks first.
        driver_log.log("postmortem_report", cycle=i, fault=fault,
                       exit_code=verdict["postmortem_exit"],
                       **verdict["postmortem"])
    ok = bool(cycles) and all(c["recovered"] for c in cycles)
    report = {
        "cycles": len(cycles), "ok": ok,
        "faults": [c["fault"] for c in cycles],
        "recovered": sum(c["recovered"] for c in cycles),
        "monitor_exits": [c["monitor_exit"] for c in cycles],
        "postmortem_exits": [c["postmortem_exit"] for c in cycles],
        "recovery_wall_s": [c["wall_s"] for c in cycles],
        "world": args.world, "smoke": bool(args.smoke),
        "data_plane": args.data_plane,
        "wall_s": round(time.perf_counter() - t0, 1),
        "per_cycle": cycles,
    }
    driver_log.log("soak_report", **report)
    driver_log.close()
    print(json.dumps(report), flush=True)
    return 0 if ok else 1


# ----------------------------------------------------------- ingestion mode

def ingest_main(args) -> dict:
    """The ingestion benchmark: the JAX tool's JSON line, measured here."""
    have = _have_data(args.data_dir)
    if have:
        # A stale dir with different geometry would silently measure the wrong
        # dataset (and out-of-range labels would silently zero in one_hot).
        imgs = np.load(os.path.join(args.data_dir, "train_images.npy"),
                       mmap_mode="r")
        labs = np.load(os.path.join(args.data_dir, "train_labels.npy"))
        want = (args.rows, args.image_size, args.image_size, 3)
        if imgs.shape != want or int(labs.max()) >= args.classes:
            raise SystemExit(
                f"{args.data_dir} holds images {imgs.shape} / labels up to "
                f"{int(labs.max())}, but this run asked for {want} / "
                f"{args.classes} classes — delete the dir or pass a fresh "
                "--data-dir")
        del imgs, labs
    gen_s = None
    if not have:
        gen_s = generate(args.data_dir, args.rows, args.image_size,
                         args.classes, args.seed)

    import torch

    from ..data.datasets import load_dataset
    from ..data.pipeline import prefetch_stream
    from ..device import resolve_device
    from ..models import create_model
    from ..ops.scoring import score_dataset
    from ..parallel.mesh import world_size
    from ..weights import init_variables

    device = resolve_device(args.device)
    train_ds, _ = load_dataset("npz", args.data_dir)
    assert isinstance(train_ds.images, np.memmap), "expected mmap ingestion"
    n = len(train_ds)
    bytes_per_row = int(np.prod(train_ds.images.shape[1:]))  # uint8
    batch = args.batch

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # --- Ingestion: one full production epoch of assembly + upload. ---
    rss_source = rss_anon_source()
    print(f"[imagenet_soak] anonymous RSS from {rss_source}", file=sys.stderr, flush=True)

    def rss_anon() -> float:
        return rss_anon_mb(rss_source)

    rss0 = rss_anon()
    peak = rss0
    t0 = time.perf_counter()
    rows = 0
    stream = prefetch_stream(train_ds, batch, device, shuffle=True, seed=args.seed,
                             epoch=0, stage="ingest")
    try:
        for db in stream:
            rows += int(db["mask"].sum())
            if rows % (batch * 64) < batch:
                peak = max(peak, rss_anon())
    finally:
        stream.close()
    sync()
    ingest_s = time.perf_counter() - t0
    peak = max(peak, rss_anon())

    # --- Scoring rate: through score_dataset, streamed. ---
    score_ds = (train_ds if args.score_rows in (0, None) or args.score_rows >= n
                else train_ds.subset(np.arange(args.score_rows, dtype=np.int64)))
    stem = "imagenet" if args.arch.startswith("resnet") else "cifar"
    model = create_model(args.arch, args.classes,
                         half_precision=args.half_precision, stem=stem)
    variables = init_variables(args.arch, 0, device, num_classes=args.classes,
                               stem=stem)
    # A warm-up pass over one batch builds the kernels, so the measured rate
    # is the steady-state scoring throughput.
    warm = score_ds.subset(np.arange(min(batch, len(score_ds)), dtype=np.int64))
    score_dataset(model, [variables], warm, method=args.score_method,
                  batch_size=batch, device_resident=False, device=device)
    sync()
    t0 = time.perf_counter()
    scores = score_dataset(model, [variables], score_ds, method=args.score_method,
                           batch_size=batch, device_resident=False, device=device)
    sync()
    score_s = time.perf_counter() - t0
    peak = max(peak, rss_anon())

    out = {
        "rows": n, "image_size": args.image_size,
        "dataset_gb": round(n * bytes_per_row / 1e9, 2),
        "generate_s": None if gen_s is None else round(gen_s, 1),
        "ingest_examples_per_s": round(rows / ingest_s, 1),
        "ingest_gb_per_s": round(rows * bytes_per_row / ingest_s / 1e9, 3),
        "score_arch": args.arch, "score_method": args.score_method,
        "score_rows": len(score_ds),
        "score_examples_per_s": round(len(score_ds) / score_s, 1),
        "rss_anon_start_mb": round(rss0, 1),
        "rss_anon_peak_mb": round(peak, 1),
        "n_devices": world_size(),
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "scores_mean": float(np.mean(scores)),
    }
    print(json.dumps(out), flush=True)
    return out


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="python -m data_diet_distributed_tpu_torch.tools.imagenet_soak",
        description="ImageNet-geometry ingestion benchmark, or the elastic "
                    "fault soak (--soak / --smoke)")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="this process's and every child's --device "
                             "(cuda: no fallback)")
    parser.add_argument("--data-dir", default="/tmp/imagenet_soak_data")
    parser.add_argument("--rows", type=int, default=200_000)
    parser.add_argument("--image-size", type=int, default=96)
    parser.add_argument("--classes", type=int, default=100)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--arch", default="resnet50")
    parser.add_argument("--score-rows", type=int, default=2048,
                        help="rows for the scoring-rate measurement "
                             "(0 = the whole train split)")
    parser.add_argument("--score-method", default="el2n")
    parser.add_argument("--half-precision", action="store_true")
    # --- soak mode ---
    parser.add_argument("--soak", action="store_true",
                        help="fault-injecting elastic soak instead of the "
                             "ingestion benchmark")
    parser.add_argument("--smoke", action="store_true",
                        help="bounded soak (tiny synthetic train workload) "
                             "— implies --soak")
    parser.add_argument("--workdir", default="/tmp/ddt_soak",
                        help="soak working directory (one subdir per cycle)")
    parser.add_argument("--data-plane", default="resident",
                        choices=["resident", "streaming"],
                        help="smoke-cycle feed: resident (synthetic in-RAM, "
                             "the default) or streaming (digest-verified "
                             "shard store + prefetch plane; default "
                             f"schedule {SMOKE_STREAMING_SCHEDULE})")
    parser.add_argument("--command", default=None,
                        help="CLI command each cycle drives (default: "
                             "train in smoke, run otherwise)")
    parser.add_argument("--schedule", default=None,
                        help=f"comma-separated fault cycle schedule from "
                             f"{sorted(FAULTS)} (default smoke: "
                             f"{SMOKE_SCHEDULE}; soak: {SOAK_SCHEDULE})")
    parser.add_argument("--cycles", type=int, default=None,
                        help="total cycles (schedule repeats); default: one "
                             "pass over the schedule")
    parser.add_argument("--duration", type=float, default=None,
                        help="stop starting new cycles after this many "
                             "seconds (the long-haul bound)")
    parser.add_argument("--world", type=int, default=None,
                        help="worker processes per cycle (default: 1 smoke, "
                             "2 soak)")
    parser.add_argument("--epochs", type=int, default=3,
                        help="soak-cycle retrain epochs (non-smoke)")
    parser.add_argument("--step-timeout", type=float, default=None,
                        help="resilience.step_timeout_s for soak children "
                             "(default 20 smoke / 120 soak)")
    parser.add_argument("--max-restarts", type=int, default=3)
    parser.add_argument("--quiet", action="store_true")
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    err = device_error(args.device)
    if err:
        raise SystemExit(err)
    if args.soak or args.smoke:
        if args.world is None:
            args.world = 1 if args.smoke else 2
        if args.step_timeout is None:
            args.step_timeout = 20.0 if args.smoke else 120.0
        if args.command is None:
            args.command = "train" if args.smoke else "run"
        return soak_main(args)
    ingest_main(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
