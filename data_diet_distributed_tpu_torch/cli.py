"""Command line of the PyTorch port (counterpart of ``data_diet_distributed_tpu/cli.py``)::

    python -m data_diet_distributed_tpu_torch.cli {train|run|sweep|score|serve} \\
        --config configs/x.yaml [key=value ...] [--device cpu]

* ``train``: dense training through ``fit_with_recovery``, checkpoints in
  ``train.checkpoint_dir``;
* ``run``: (pretrain ->) score -> prune -> retrain -> eval, writing
  ``<train.checkpoint_dir>_scores.npz`` and its provenance sidecar;
* ``sweep``: one scoring pass, then prune and retrain per ``prune.sweep``
  level;
* ``score``: score only (after ``score.pretrain_epochs`` epochs per seed, from
  ``score.score_ckpt_step``, or reused from ``score.scores_npz``) and write
  ``<train.checkpoint_dir>_scores.npz`` with ``scores``, ``indices`` and
  ``method``;
* ``serve``: scoring as a service (``serve/server.py::run_serve``): register
  the dataset as tenant ``serve.tenant`` (default ``data.dataset``) with the
  scoring variables of the ``score`` recipe, score ``serve.methods`` (this
  builds the CUDA kernels), bind ``serve.host:serve.port`` (0 = a free port,
  announced by the ``obs_server`` record on stderr) and answer
  ``/v1/score``, ``/v1/rank``, ``/v1/topk``, ``/v1/refresh``, ``/healthz``,
  ``/metrics``, ``/status`` and ``/flightrec`` until SIGTERM/SIGINT, which
  drains the accepted requests (``serve.drain_timeout_s``) and exits 75 with
  ``[preempted] ...`` on stdout. Its records (``{"ts", "kind", ...}``) go to
  ``obs.metrics_path`` and stderr, ending in ``run_summary``. With
  ``serve.replicas > 1`` or ``serve.max_replicas`` set it is the serving
  fleet (``serve/fleet.py::ServeFleet``): a supervisor that touches no CUDA
  starts that many ``cli serve`` replicas (each with ``DDT_SERVE_REPLICA``
  and the supervisor's ``--device``; on one card they share it), fronts them
  with the health-aware router on ``serve.router_port`` (0 = a free port,
  announced by the ``serve_fleet`` ``launch`` record), respawns a dead or
  wedged replica on its port, rolls refreshes and tuning manifests one
  replica at a time and exits 75 on SIGTERM after the replicas drain; its
  terminal ``run_summary`` carries the fleet's ``exit_class`` and
  ``lineage``. ``mesh.multihost`` refuses by name for serving.

``score``, ``run`` and ``sweep`` take every ``score.method``, the trajectory
scores ``forgetting`` and ``aum`` included (their per-seed fits are the
scoring pass), and every command takes ``model.remat``.

Each command prints its summary as one JSON line on stdout; the event records
along the way (epochs, prune decisions, faults, recoveries, stages, the
introspection and telemetry records) go to ``obs.metrics_path`` and to stderr
as JSON lines, ending in a registry snapshot (``metrics``) and ``run_summary``.
Every command runs under ``obs/session.py::ObsSession`` inside a ``run``
span; ``obs.monitor`` samples utilization into ``obs.monitor_path`` for the
command's duration, and ``obs.perf_ledger`` gets one ``perf_history`` record
per command (``backend`` ``cuda`` or ``cpu``, ``device_kind`` the card's
name). The device is CUDA unless ``--device cpu``; without CUDA the command
raises. Drive a CPU service with ``tools/serve_client.py --url
http://127.0.0.1:<port>`` and end it with ``kill -TERM <pid>`` (exit 75).

Tuning: after the device is resolved and before any module that reads a
``DDT_GRAND_*`` gate is imported, ``tuning.py::maybe_apply_manifest`` applies
a matching signed manifest (``tuning.manifest``, default
``artifacts/tuning_manifest.json`` under the working directory;
``tuning.apply`` auto | off | strict) and logs its decision as a
``tuning_applied`` record; a corrupt manifest, or under ``strict`` a missing
or mismatched one, prints ``[tuning] ...`` on stderr and exits 2.

Resilience as in the JAX package: a SIGTERM/SIGINT ends the command after a
final checkpoint with ``[preempted] ...`` on stdout and exit status 75;
``run``, ``sweep`` and ``score`` re-invoked with the same arguments re-enter
at their stage (``train`` resumes with ``train.resume=true``). A JSON fault
plan in ``DDT_FAULT_PLAN`` (``resilience/inject.py``) arms a drill, and
``resilience.init_probe=true`` first initializes CUDA in a bounded
subprocess (exit 69 when it fails).

Supervised: with ``elastic.enabled=true`` the command becomes a restart
supervisor (``resilience/elastic.py::ElasticSupervisor``) that touches no
CUDA: it starts ``elastic.world`` workers of the same command (each with
``DDT_ELASTIC_CHILD=1``, the mesh keys of its rank and the supervisor's
``--device``; their output in ``<train.checkpoint_dir>_elastic/``), and after
a worker's death relaunches the survivors with ``train.resume=true``; a join
request grows the world at the next stage boundary. Its ``elastic_event``
records and a terminal ``run_summary`` (``exit_class``, ``lineage``; or
``fatal:supervisor``) go to ``obs.metrics_path`` beside the workers', its
exit status is the run's. With CUDA each worker takes a card, so one card
runs ``elastic.world=1``; ``--device cpu`` runs W workers over gloo. Judge
the run afterwards with ``python -m
data_diet_distributed_tpu_torch.obs.postmortem <workdir>``.

Several processes: with ``mesh.multihost=true mesh.coordinator_address=H:P
mesh.num_processes=W mesh.process_id=r`` each process joins the group
(NCCL on CUDA, gloo with ``--device cpu``) before it loads data, and the W
processes run the command as one data-parallel job. Rank 0 prints the
records and the summary and writes the files; every rank exits 75 on an
agreed preemption, and a failure under the group exits at once (69 for a
``RuntimeError``, a peer's poison or a hang among them; 1 otherwise), since
the teardown of a group with a dead peer can hang.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch

from .config import Config, load_config
from .device import resolve_device
from .obs import lineage, tracing
from .obs.metrics import MetricsLogger, emit_run_summary
from .obs.monitor import ResourceMonitor
from .obs.session import ObsSession
from .ops import kernels
from .parallel.mesh import initialize_multihost, is_primary, shutdown, world_size
from .resilience import elastic, inject
from .resilience.preemption import EXIT_PREEMPTED, Preempted
from .resilience.watchdog import EXIT_RETRIABLE, probe_devices
from .tuning import TuningError, maybe_apply_manifest
from .utils.io import atomic_append_jsonl, atomic_savez

# The training loop and the service are imported inside the commands: they
# import ops/grand_batched.py, which reads the DDT_GRAND_* gates once, at its
# import, and a tuning manifest sets those gates after the device resolves.

#: Exit status of a tuning manifest the run must not proceed with.
EXIT_TUNING = 2


def score(cfg: Config, device, log) -> dict:
    """The ``score`` command: score (stage-resumable, like ``run``), save the
    npz, return a summary."""
    from .train.loop import compute_scores, load_data_for, pipeline_stages, scores_npz_path
    train_ds, _ = load_data_for(cfg)
    scores, timings = compute_scores(cfg, train_ds, device=device, log=log,
                                     stages=pipeline_stages(cfg, log))
    out = scores_npz_path(cfg.train.checkpoint_dir)
    method = (f"reused:{timings['loaded_from']}" if timings.get("loaded_from")
              else cfg.score.method)
    if is_primary():   # every rank holds the same scores; one writes
        atomic_savez(out, scores=scores, indices=train_ds.indices, method=method)
    return {"n_scores": int(len(scores)), "scores_npz": out,
            "score_s": round(timings["score_s"], 3),
            "pretrain_s": round(timings["pretrain_s"], 3), "device": str(device),
            "mean": float(scores.mean()), "std": float(scores.std())}


def train(cfg: Config, device, log) -> dict:
    """The ``train`` command: a dense fit with checkpoints and recovery."""
    from .train.loop import fit_with_recovery, load_data_for
    train_ds, test_ds = load_data_for(cfg)
    res = fit_with_recovery(cfg, train_ds, test_ds, device=device, log=log,
                            checkpoint_dir=cfg.train.checkpoint_dir, tag="dense")
    return {**res.throughput_summary(), "train_wall_s": round(res.wall_s, 3),
            "device": str(device)}


def _refuse_serve(cfg: Config) -> None:
    """A serve replica is one process on one device: a multi-host service is
    not ported."""
    if cfg.mesh.multihost:
        raise NotImplementedError(
            "cli serve is one process on one device; mesh.multihost is not "
            "supported for serving")


def _dispatch(command: str, cfg: Config, device, logger: MetricsLogger) -> dict:
    """Run the command; returns its summary line."""
    if command == "serve":   # returns only by raising (Preempted on SIGTERM)
        from .serve.server import run_serve
        return {"event": "serve_done", **run_serve(cfg, logger, device)}
    if command == "score":
        return {"event": "scores_saved", **score(cfg, device, logger)}
    if command == "train":
        return {"event": "train_done", **train(cfg, device, logger)}
    from .train.loop import run_datadiet, run_sweep
    if command == "run":
        return {"event": "run_done", **run_datadiet(cfg, device=device, log=logger)}
    return {"event": "sweep_done", "levels": run_sweep(cfg, device=device, log=logger)}


def _final(out: dict | None) -> dict | None:
    """The ``run_summary`` ``final`` block: the headline numbers of a summary
    line (the JAX package's per command)."""
    if out is None:
        return None
    if out["event"] == "sweep_done":
        return {"levels": [s.get("sparsity") for s in out["levels"]],
                "final_test_accuracy": [s.get("final_test_accuracy")
                                        for s in out["levels"]]}
    keys = {"run_done": ("final_test_accuracy", "sparsity", "score_method", "n_kept",
                         "total_wall_s"),
            "train_done": ("epochs", "epoch_s", "examples_per_s",
                           "final_test_accuracy"),
            "scores_saved": ("n_scores", "scores_npz", "score_s", "pretrain_s")}
    return {k: out.get(k) for k in keys.get(out["event"], ())}


def _hardware(device) -> tuple[str, str]:
    """``(backend, device_kind)`` as the ledger and tuning manifests name the
    port's hardware: ``cuda`` and the card's name, or ``cpu`` and ``cpu``."""
    dev = torch.device(device) if device is not None else torch.device("cpu")
    if dev.type == "cuda":
        return "cuda", torch.cuda.get_device_name(dev)
    return dev.type, dev.type


def _append_perf_ledger(cfg: Config, command: str, summary: dict, device) -> None:
    """One ``{"kind": "perf_history"}`` record per command into
    ``obs.perf_ledger`` (off when None), with the JAX package's fields; rank 0
    only, and never the thing that fails a run. ``backend`` is ``cuda`` or
    ``cpu`` and ``device_kind`` the card's name, so ``tools/perf_sentry.py``
    never groups a port record with a TPU one."""
    if not cfg.obs.perf_ledger or not is_primary():
        return
    try:
        final = summary.get("final") or {}
        lin = lineage.ensure()
        backend, device_kind = _hardware(device)
        rec = {
            "kind": "perf_history", "ts": round(time.time(), 3),
            "run_id": lin.run_id, "attempt": lin.attempt,
            "source": "cli", "metric": f"cli_{command}_wall_s",
            "value": summary.get("wall_s"), "unit": "seconds",
            "exit_class": summary.get("exit_class"),
            "backend": backend,
            "device_kind": device_kind,
            "n_devices": world_size(),
            "geometry": {"dataset": cfg.data.dataset, "arch": cfg.model.arch,
                         "batch": cfg.data.batch_size, "epochs": cfg.train.num_epochs,
                         "method": cfg.score.method},
        }
        for k in ("examples_per_s", "final_test_accuracy", "total_wall_s"):
            if isinstance(final.get(k), (int, float)):
                rec[k] = final[k]
        if "mfu" in summary:
            rec["mfu"] = summary["mfu"]
        if isinstance(summary.get("slo"), dict):
            rec["slo"] = {"ok": summary["slo"].get("ok"),
                          "violations": summary["slo"].get("violations")}
        atomic_append_jsonl(cfg.obs.perf_ledger, rec)
    except Exception as exc:   # noqa: BLE001 — the ledger is observability
        print(f"[obs] perf ledger append failed: {exc!r}", file=sys.stderr, flush=True)


def _observed(command: str, cfg: Config, device_arg) -> dict:
    """The command under ``ObsSession`` and a ``run`` span, its records in
    ``obs.metrics_path`` and on stderr; the stream ends in the registry
    snapshot and ``run_summary`` however the command ends."""
    device = resolve_device(device_arg)
    logger = MetricsLogger(cfg.obs.metrics_path)
    try:
        # Before _dispatch imports the modules that read the gates it sets.
        backend, device_kind = _hardware(device)
        decision = maybe_apply_manifest(cfg, backend=backend, device_kind=device_kind)
    except TuningError:
        logger.close()
        raise
    if decision is not None:
        logger.log("tuning_applied", **decision)
    monitor = (ResourceMonitor(cfg.obs.monitor_path, device=device)
               if cfg.obs.monitor and is_primary() else None)
    if monitor is not None:
        monitor.start()
    t0 = time.perf_counter()
    out = None
    exit_class = "ok"
    try:
        with ObsSession(cfg, logger=logger, device=device) as obs:
            try:
                with tracing.span("run", cat="run", command=command):
                    out = _dispatch(command, cfg, device, logger)
                return out
            except Preempted:
                exit_class = "preempted"
                raise
            except BaseException as exc:
                exit_class = f"fatal:{type(exc).__name__}"
                raise
            finally:
                try:
                    # The kernels' launches in this process, for a reader of
                    # the stream (a supervised attempt's among them).
                    for name, n in kernels.launch_counts().items():
                        if n:
                            obs.registry.gauge(f"kernel_launches:{name}").set(n)
                    logger.log("metrics", **obs.registry.snapshot())
                    summary = emit_run_summary(
                        logger, wall_s=time.perf_counter() - t0, exit_class=exit_class,
                        command=command, final=_final(out), registry=obs.registry)
                    _append_perf_ledger(cfg, command, summary, device)
                except Exception as exc:   # noqa: BLE001 — never masks the outcome
                    print(f"[obs] run_summary emission failed: {exc!r}",
                          file=sys.stderr, flush=True)
    finally:
        logger.close()
        if monitor is not None:
            monitor.stop()


def _serve_fleet(cfg: Config, args) -> int:
    """``serve.replicas > 1`` or ``serve.max_replicas``: supervise a fleet of
    ``cli serve`` replicas behind the router; returns the fleet's exit status
    (75 after a SIGTERM drain). The terminal ``run_summary`` carries the
    fleet's ``exit_class`` and ``lineage`` (replicas, generations, respawns,
    restarts left)."""
    from .serve.fleet import ServeFleet
    logger = elastic.JsonlLogger(cfg.obs.metrics_path)
    fleet = ServeFleet(cfg, config_path=args.config, overrides=args.overrides,
                       logger=logger, device=args.device)
    t0 = time.perf_counter()
    try:
        rc = fleet.run()
    except BaseException:
        logger.log("run_summary", wall_s=round(time.perf_counter() - t0, 3),
                   exit_class="fatal:supervisor", command="serve")
        logger.close()
        raise
    logger.log("run_summary", wall_s=round(time.perf_counter() - t0, 3),
               exit_class=fleet.exit_class(rc), command="serve",
               lineage=fleet.lineage_block())
    logger.close()
    return rc


def _supervise(command: str, cfg: Config, args) -> int:
    """``elastic.enabled``: supervise workers of this same command; returns
    the run's exit status. The terminal ``run_summary`` judges the whole
    lineage (attempts, worlds, recoveries), not the last attempt."""
    logger = elastic.JsonlLogger(cfg.obs.metrics_path)
    supervisor = elastic.ElasticSupervisor(cfg, command, config_path=args.config,
                                           overrides=args.overrides, logger=logger,
                                           device=args.device)
    t0 = time.perf_counter()
    try:
        rc = supervisor.run()
    except BaseException:
        logger.log("run_summary", wall_s=round(time.perf_counter() - t0, 3),
                   exit_class="fatal:supervisor", command=command)
        logger.close()
        raise
    logger.log("run_summary", wall_s=round(time.perf_counter() - t0, 3),
               exit_class=supervisor.exit_class(rc), command=command,
               lineage=supervisor.lineage_block())
    logger.close()
    return rc


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="data_diet_distributed_tpu_torch.cli")
    parser.add_argument("command", choices=("score", "train", "run", "sweep", "serve"))
    parser.add_argument("--config", default=None)
    parser.add_argument("--device", default=None,
                        help="cuda (default; raises without CUDA) or cpu")
    parser.add_argument("overrides", nargs="*", help="dotted.key=value overrides")
    args = parser.parse_intermixed_args(argv)
    cfg = load_config(args.config, args.overrides)
    if args.command == "serve":
        _refuse_serve(cfg)
        if ((cfg.serve.replicas > 1 or cfg.serve.max_replicas is not None)
                and os.environ.get("DDT_SERVE_REPLICA") is None):
            # Before the elastic branch, the fault plan and any device: a
            # serve command with replicas is a fleet whatever elastic.enabled
            # says, and its supervisor never touches the card its replicas
            # share. An autoscaled fleet is a fleet even at replicas=1.
            return _serve_fleet(cfg, args)
    if cfg.elastic.enabled and os.environ.get(elastic.CHILD_ENV) != "1":
        # Before the fault plan and any device: the supervisor fires no fault
        # site and never touches the card, which its workers take.
        return _supervise(args.command, cfg, args)
    plan = inject.activate_from_env()
    if plan is not None:
        print(f"[resilience] fault plan armed from DDT_FAULT_PLAN: {plan}",
              file=sys.stderr, flush=True)
    try:
        # Before this process touches CUDA (resolve_device's is_available()
        # would): a wedged driver then hangs the killable child, not us.
        # Skipped under multihost: the child would not join the group.
        if (cfg.resilience.init_probe and not cfg.mesh.multihost
                and torch.device(args.device or "cuda").type == "cuda"):
            info = probe_devices(cfg.resilience.probe_attempts,
                                 cfg.resilience.probe_timeout_s,
                                 cfg.resilience.probe_backoff_s)
            if "error" in info:
                print(f"[resilience] {info['error']}", file=sys.stderr, flush=True)
                return EXIT_RETRIABLE
        initialize_multihost(cfg.mesh, args.device)
        try:
            out = _observed(args.command, cfg, args.device)
        except TuningError as err:
            print(f"[tuning] {err}", file=sys.stderr, flush=True)
            shutdown()
            return EXIT_TUNING
        except Preempted as p:
            # The final checkpoint (or the seed's partial) is durable and the
            # "preempted" event is already logged: report the resume point
            # with a status a supervisor can branch on.
            print(f"[preempted] {p}", flush=True)
            shutdown()
            return EXIT_PREEMPTED
        except Exception as exc:  # noqa: BLE001 — a bounded exit under a group
            if world_size() <= 1:
                raise
            traceback.print_exc()
            print("[resilience] fatal under the process group: bounded exit "
                  "(a teardown with a dead peer can hang)", file=sys.stderr, flush=True)
            sys.stdout.flush()
            os._exit(EXIT_RETRIABLE if isinstance(exc, RuntimeError) else 1)
    finally:
        if plan is not None:
            inject.deactivate()
    primary = is_primary()
    shutdown()
    if primary:
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
