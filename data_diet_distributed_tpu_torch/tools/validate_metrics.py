"""Schema validator for the metrics JSONL stream.

The port's copy of ``tools/validate_metrics.py``: standard library only, the
same kinds, required fields, functions and ``main``, run as ``python -m
data_diet_distributed_tpu_torch.tools.validate_metrics``.

The JSONL is the run's public API — recovery tooling, ``trace_report``-style
post-mortems, plots, and the tests all filter on ``kind`` and trust per-kind
required fields. This validator pins that contract: every line parses as
JSON, every record carries ``ts`` and a ``kind`` from the known set, and the
structured event kinds (fault / stage / consensus / recovery / preempted /
run_summary / metrics) carry their required fields. A final-line check
(``--expect-terminal``) asserts the stream ends with the ``run_summary``
terminal event the CLI emits.

Usage::

    python -m data_diet_distributed_tpu_torch.tools.validate_metrics <metrics.jsonl> [...]
    python -m data_diet_distributed_tpu_torch.tools.validate_metrics --expect-terminal metrics.jsonl

Exit 0 = valid; 1 = violations (each printed as ``path:line: problem``).
Library use: ``validate_lines`` / ``validate_file`` return the violation list
(tier-1 tests run them over the streams the test runs produce).

A trailing PARTIAL line (a run killed mid-write) is tolerated by design —
every other consumer of the stream tolerates it too (``obs/plots.py``).
"""

from __future__ import annotations

import argparse
import json
import sys

#: Every event kind the framework emits (grep `logger.log(` /
#: `logger.fault|stage|consensus`). An unknown kind is a violation: either a
#: typo in new instrumentation, or a new kind that must be added HERE so the
#: stream's consumers know about it.
KNOWN_KINDS = frozenset({
    # training / pipeline progress
    "train_step", "train_chunked", "epoch", "resume", "summary", "prune",
    "sweep_scored", "sweep_done", "scores_saved", "scores_loaded",
    "score_seeds_resumed", "score_ckpt_loaded", "forgetting_seed_done",
    "aum_seed_done",
    # resilience
    "fault", "recovery", "recovery_refused", "preempted", "stage",
    "consensus",
    # observability layer
    "metrics", "run_summary",
    # XLA/device introspection (obs/xla.py) + the perf-history ledger
    # (tools/perf_sentry.py reads streams of the latter)
    "xla_program", "hbm_watermark", "perf_history",
    # Score Observatory (obs/scoreboard.py + pruning provenance): per-seed
    # score distributions, cross-seed rank stability, prune decisions.
    "score_stats", "score_stability", "prune_decision",
    # Live introspection layer (obs/server.py, obs/fleet.py, obs/slo.py):
    # server lifecycle, cross-rank fleet snapshots, SLO violations.
    "obs_server", "fleet_status", "slo_violation",
    # Pod-scale comm/checkpoint layer (obs/comm.py, checkpoint.py LocalTier):
    # per-step collective-byte estimates + overlap verdict, and per-save
    # checkpoint-tier transitions (local -> durable promotion, errors).
    "comm_stats", "ckpt_tier",
    # Elastic pod (resilience/elastic.py + tools/imagenet_soak.py):
    # supervisor decisions (launch/shrink/grow/restart/give_up, stage-
    # boundary resize honors) and the soak driver's terminal verdict.
    "elastic_event", "soak_report",
    # Postmortem engine (obs/timeline.py + obs/postmortem.py): the
    # whole-lineage forensics verdict — emitted by `postmortem --json` and
    # embedded per cycle by the soak driver.
    "postmortem_report",
    # Scoring-as-a-service (serve/): per-request latency records, the serve
    # loop's aggregate stats/SLO cadence, and admission-control decisions
    # (429 rejections, drain transitions).
    "serve_request", "serve_stats", "serve_admission",
    # Serving fleet (serve/fleet.py + serve/router.py): fleet lifecycle
    # (supervise/launch/stats/drain/give_up/complete), per-replica
    # deaths/wedges/respawns + router breaker transitions, and model
    # refresh installs/rejections/rolls. autoscale_event records every
    # SLO-driven fleet-size decision (scale_up/scale_down/at_max) with
    # the evidence that forced it.
    "serve_fleet", "replica_event", "model_refresh", "autoscale_event",
    # Streaming data plane (data/pipeline.py + ops/scoring.py): one record
    # per fit/score pass naming the feed engine (resident / stream /
    # chunked_stream) with prefetch stall accounting and the host shard-cache
    # watermark.
    "data_plane",
    # Storage faults (data/sharded.py): data_fault is one read failure
    # (transient_io / digest_mismatch), recovered=True when a retry served
    # verified bytes; shard_quarantine marks a shard exhausted its retries —
    # the pass either aborted (typed ShardReadError) or, under
    # data.skip_quarantined, dropped the shard's rows from scoring.
    "data_fault", "shard_quarantine",
    # Autotuner (tools/autotune.py + tuning.py):
    # autotune_event is the search's decision stream (search_start /
    # pruned_negative / measured / verified / disqualified / winner /
    # manifest_written / confirmed); tuning_applied is the CLI's startup
    # verdict on the signed manifest (applied or skipped, with reason,
    # knobs, and the precedence-skipped set).
    "autotune_event", "tuning_applied",
    # Request observatory (obs/reqtrace.py): one per-request distributed
    # trace with the X-Trace-Id identity, the emitting side ("router" /
    # "replica"), and the per-phase latency breakdown. Tail-biased
    # retention: failed/slow/retried/hedged/replayed requests always
    # emit; healthy traffic head-samples via serve.trace_sample_frac.
    "serve_trace",
})

#: kind -> fields every record of that kind must carry.
REQUIRED_FIELDS: dict[str, tuple[str, ...]] = {
    "fault": ("fault",),
    "stage": ("stage", "status"),
    "consensus": ("event", "rank"),
    "recovery": ("cause",),
    "preempted": ("signal",),
    "epoch": ("epoch", "train_loss"),
    "run_summary": ("wall_s", "exit_class"),
    "metrics": ("counters", "gauges", "histograms"),
    # compile_s/flops may be null (a backend refusing to analyze degrades,
    # never crashes) but the KEYS must be present — a consumer can rely on
    # the shape.
    "xla_program": ("program", "compile_s", "flops"),
    "hbm_watermark": ("device", "bytes_in_use", "peak_bytes"),
    "perf_history": ("source", "metric", "value", "unit"),
    # Score Observatory records. Null-tolerant like xla_program: an
    # all-NaN score vector degrades mean/std to null, a degenerate
    # stability pass degrades ρ to null — the KEYS must be present so
    # consumers can rely on the shape.
    "score_stats": ("method", "seed", "n", "mean", "std", "nan_count"),
    "score_stability": ("method", "n_seeds", "spearman_pairwise_mean",
                        "overlap_at_keep"),
    "prune_decision": ("method", "sparsity", "n_total", "n_kept",
                       "kept_digest", "manifest"),
    # Live introspection. Null-tolerant like xla_program: a fleet with no
    # step-reporting heartbeats degrades max_step/straggler_rank to null, a
    # violation's value may be null on a degenerate input — the KEYS must
    # be present so consumers can rely on the shape.
    "obs_server": ("event",),
    "fleet_status": ("n_ranks", "ranks", "stalest_rank", "stalest_age_s",
                     "straggler_rank"),
    "slo_violation": ("slo", "value", "threshold"),
    # Pod-scale comm/checkpoint records. Null-tolerant like xla_program: the
    # overlap ratio degrades to null when no link-bandwidth/cost-analysis is
    # known (CPU lanes) — the KEYS must be present so consumers can rely on
    # the shape.
    "comm_stats": ("mesh", "bytes_per_step", "overlap_ratio",
                   "sharded_update"),
    "ckpt_tier": ("step", "tier"),
    # Elastic pod. Null-tolerant like xla_program: a stage-boundary resize
    # honor has no rcs, a give_up has no new_world — only the event name is
    # universal; per-event payloads ride as optional fields.
    "elastic_event": ("event",),
    "soak_report": ("cycles", "ok"),
    # Postmortem verdict. Null-tolerant like xla_program: run_id is null
    # over a pre-lineage stream, recoveries may be empty — the KEYS must be
    # present so consumers can rely on the shape.
    "postmortem_report": ("attempts", "recoveries", "ok"),
    # Serving records. Null-tolerant like xla_program: a stats point before
    # any completed request degrades p95_ms to null — the KEYS must be
    # present so consumers can rely on the shape.
    "serve_request": ("tenant", "method", "n", "wall_ms"),
    "serve_stats": ("requests", "dispatches", "p95_ms"),
    "serve_admission": ("tenant", "action"),
    # Serving fleet. Null-tolerant like elastic_event: only the event name
    # (and the replica index, for replica_event) is universal — a breaker
    # transition has no rc, a spawn has no signal. model_refresh's tenant
    # may be null on a fleet-wide roll with no tenant named.
    "serve_fleet": ("event",),
    "replica_event": ("replica", "event"),
    "model_refresh": ("tenant", "status"),
    # Autoscaler decisions. Null-tolerant like elastic_event: evidence
    # values (tick p95, queue depth) may be null on a traffic-free tick —
    # the action and the before/after sizes are universal.
    "autoscale_event": ("action", "replicas_from", "replicas_to"),
    # Data-plane records. Null-tolerant like xla_program: a resident pass
    # has no prefetch thread, so stall_s/stall_frac degrade to null — the
    # KEYS must be present so consumers can rely on the shape.
    "data_plane": ("stage", "engine", "prefetch_depth", "stall_s",
                   "stall_frac", "host_cache_bytes_in_use"),
    # Storage-fault records. rank is null-tolerant (the process group may
    # not be initialized in the library code that classifies the failure).
    "data_fault": ("split", "shard", "rank", "error_class", "retries",
                   "recovered"),
    "shard_quarantine": ("split", "shard", "rank", "error_class"),
    # Autotuner records. Null-tolerant like elastic_event: per-event
    # payloads (combo, value, digest) ride as optional fields; the
    # tuning_applied verdict always carries the decision triple.
    "autotune_event": ("event",),
    "tuning_applied": ("applied", "mode", "manifest"),
    # Request traces. Null-tolerant: status may be null when the socket
    # died before a status existed, and phases' VALUES may be null — but
    # the identity (trace_id), the emitting side, the wall, and the
    # phases dict itself must always be present.
    "serve_trace": ("trace_id", "where", "status", "wall_ms", "phases"),
}

#: Valid statuses for stage events (resilience/stages.py vocabulary).
STAGE_STATUSES = frozenset({"started", "done", "skipped", "reset", "invalid",
                            "resuming"})


def validate_lines(lines, *, where: str = "<stream>",
                   expect_terminal: bool = False) -> list[str]:
    """Violations as ``where:lineno: problem`` strings (empty = valid)."""
    problems: list[str] = []
    last_kind = None
    records = 0
    lines = list(lines)
    for i, line in enumerate(lines, start=1):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            if i == len(lines):
                continue   # partial trailing line from a killed run: tolerated
            problems.append(f"{where}:{i}: not valid JSON")
            continue
        if not isinstance(rec, dict):
            problems.append(f"{where}:{i}: not a JSON object")
            continue
        records += 1
        kind = rec.get("kind")
        if "ts" not in rec or not isinstance(rec["ts"], (int, float)):
            problems.append(f"{where}:{i}: missing numeric 'ts'")
        if kind is None:
            problems.append(f"{where}:{i}: missing 'kind'")
            continue
        if kind not in KNOWN_KINDS:
            problems.append(f"{where}:{i}: unknown kind {kind!r}")
            continue
        last_kind = kind
        # Lineage fields (obs/lineage.py) ride EVERY kind, null-tolerant:
        # a pre-lineage stream omits them entirely, but a present stamp
        # must be well-typed — the postmortem joins on these.
        if "run_id" in rec and rec["run_id"] is not None \
                and not isinstance(rec["run_id"], str):
            problems.append(f"{where}:{i}: 'run_id' must be a string or "
                            "null")
        if "attempt" in rec and rec["attempt"] is not None \
                and not (isinstance(rec["attempt"], int)
                         and not isinstance(rec["attempt"], bool)
                         and rec["attempt"] >= 0):
            problems.append(f"{where}:{i}: 'attempt' must be a "
                            "non-negative integer or null")
        for field in REQUIRED_FIELDS.get(kind, ()):
            if field not in rec:
                problems.append(
                    f"{where}:{i}: kind {kind!r} missing required "
                    f"field {field!r}")
        if kind == "serve_trace" and "phases" in rec \
                and not isinstance(rec["phases"], dict):
            problems.append(
                f"{where}:{i}: serve_trace 'phases' must be an object "
                "(phase -> ms-or-null)")
        if kind == "stage" and rec.get("status") not in STAGE_STATUSES:
            problems.append(
                f"{where}:{i}: stage status {rec.get('status')!r} not in "
                f"{sorted(STAGE_STATUSES)}")
    if expect_terminal and last_kind != "run_summary":
        problems.append(
            f"{where}: last event kind is {last_kind!r}, expected the "
            "'run_summary' terminal event")
    if records == 0:
        problems.append(f"{where}: no records")
    return problems


def validate_file(path: str, *, expect_terminal: bool = False) -> list[str]:
    with open(path) as fh:
        return validate_lines(fh, where=path, expect_terminal=expect_terminal)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="Validate a metrics JSONL stream against the known "
                    "event schema")
    parser.add_argument("paths", nargs="+")
    parser.add_argument("--expect-terminal", action="store_true",
                        help="require the stream to end with a run_summary "
                             "event (streams written by the CLI do)")
    args = parser.parse_args(argv)
    all_problems: list[str] = []
    for path in args.paths:
        all_problems += validate_file(path,
                                      expect_terminal=args.expect_terminal)
    for p in all_problems:
        print(p, file=sys.stderr)
    if not all_problems:
        print(f"OK: {len(args.paths)} stream(s) valid")
    return 1 if all_problems else 0


if __name__ == "__main__":
    raise SystemExit(main())
