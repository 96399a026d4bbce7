"""PyTorch port: the cross-attempt timeline (``obs/timeline.py``), the recovery
SLO (``obs/slo.py``) and the post-mortem (``obs/postmortem.py``), against the
JAX package's ``obs/timeline.py``, ``obs/slo.py`` and ``tools/postmortem.py``;
and one real supervised drill of the port's CLI.

The drill is the JAX drill's command and overrides (``tests/conftest.py``'s
``elastic_drill``: ``cli train``, tiny_cnn, 256 examples, 3 epochs, the local
tier, ``elastic.world=2``) run by ``python -m
data_diet_distributed_tpu_torch.cli --device cpu``: two gloo ranks, rank 1
SIGKILLed after epoch 1, the supervisor shrinks to rank 0 and relaunches it
with resume. It runs once, in a module fixture, and must meet what
``tests/test_elastic.py`` asks of the JAX drill. The JAX and the port's
post-mortem then judge the same artifacts and must agree, as they must on the
hand-made streams of ``tests/test_postmortem.py``.
"""

import json
import os
import subprocess
import sys
import time

import pytest

from data_diet_distributed_tpu.obs import lineage as jax_lineage
from data_diet_distributed_tpu.obs import slo as jax_slo
from data_diet_distributed_tpu.obs import timeline as jax_timeline
from data_diet_distributed_tpu_torch.obs import lineage, postmortem, slo, timeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import postmortem as jax_postmortem  # noqa: E402
from validate_metrics import validate_file  # noqa: E402

#: The gloo aborts of an oversubscribed box (tests/conftest.py's tuple).
from conftest import INFRA_CRASH_SIGNATURES  # noqa: E402


def _drill_cmd(out):
    return [
        sys.executable, "-m", "data_diet_distributed_tpu_torch.cli", "train",
        "--device", "cpu",
        "data.dataset=synthetic", "data.synthetic_size=256",
        "data.batch_size=64", "data.eval_batch_size=64",
        "model.arch=tiny_cnn", "optim.lr=0.1", "train.num_epochs=3",
        "train.half_precision=false", "train.checkpoint_every=1",
        "train.log_every_steps=1000",
        f"train.checkpoint_dir={out}/ckpt",
        f"obs.metrics_path={out}/metrics.jsonl",
        "checkpoint.local_tier=true",
        "resilience.step_timeout_s=12", "resilience.consensus_grace_s=6",
        "obs.slo_recovery_s=240",
        "elastic.enabled=true", "elastic.world=2", "elastic.backoff_s=0.2",
        "elastic.reap_timeout_s=60",
        "score.pretrain_epochs=0",
    ]


def _read(path):
    out = []
    try:
        with open(path) as fh:
            for line in fh:
                try:
                    if line.strip():
                        out.append(json.loads(line))
                except ValueError:
                    continue   # a rank killed mid-write leaves a torn tail
    except OSError:
        pass
    return out


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_elastic_drill")
    env = dict(os.environ, DDT_FAULT_PLAN='{"rank": 1, "kill_rank_after_epoch": 1}',
               PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    for attempt in range(3):
        out = base / f"try{attempt}"
        out.mkdir()
        proc = subprocess.run(_drill_cmd(out), env=env, cwd=REPO, capture_output=True,
                              text=True, timeout=400)
        records = _read(out / "metrics.jsonl")
        logs = proc.stdout + proc.stderr + "".join(
            p.read_text(errors="replace")
            for p in sorted((out / "ckpt_elastic").glob("child_*.log")))
        if proc.returncode == 0 or not any(s in logs for s in INFRA_CRASH_SIGNATURES):
            break
    return {"rc": proc.returncode, "records": records, "logs": logs, "dir": out}


def test_drill_shrinks_to_the_survivor_and_resumes(drill):
    """What ``tests/test_elastic.py`` asks of the JAX drill, of the port's."""
    records = drill["records"]
    assert drill["rc"] == 0, drill["logs"][-3000:]
    events = [r for r in records if r.get("kind") == "elastic_event"]
    shrink = next(r for r in events if r["event"] == "shrink")
    assert shrink["dead_ranks"] == [1] and shrink["new_world"] == 1
    assert "complete" in [r["event"] for r in events]
    resumes = [r for r in records if r.get("kind") == "resume"]
    assert resumes, records[-10:]
    assert resumes[-1]["world"] == 1 and resumes[-1]["saved_world"] == 2
    assert resumes[-1]["step"] in (4, 8)
    summaries = [r for r in records if r.get("kind") == "run_summary"]
    assert summaries[-1]["exit_class"] == "ok"
    assert summaries[-1]["lineage"]["attempts"] == 2
    assert summaries[-1]["lineage"]["recoveries"] == 1
    assert summaries[-1]["lineage"]["worlds"] == [2, 1]
    assert 2 in {r["epoch"] for r in records if r.get("kind") == "epoch"}
    assert not validate_file(str(drill["dir"] / "metrics.jsonl"))
    monitor = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "run_monitor.py"),
         "--metrics", str(drill["dir"] / "metrics.jsonl"), "--once", "--json"],
        capture_output=True, text=True, timeout=60)
    assert monitor.returncode == 0, monitor.stdout
    view = json.loads(monitor.stdout.strip().splitlines()[-1])
    assert view["lineage"]["attempts"] == 2 and view["lineage"]["unexplained"] == []
    # One run_id across the supervisor's and both attempts' records; the
    # recovery SLO evaluated on the relaunched attempt.
    assert len({r["run_id"] for r in records}) == 1
    assert {r["attempt"] for r in records} == {0, 1}
    worker = [r for r in summaries if r.get("attempt") == 1 and "slo" in r]
    assert worker[-1]["slo"]["ok"] is True
    assert worker[-1]["slo"]["objectives"]["recovery_s"] == 240


def _without_ts(report):
    return {k: v for k, v in report.items() if k != "ts"}


def test_postmortem_of_the_drill_equals_jax(drill, tmp_path, capsys):
    metrics = str(drill["dir"] / "metrics.jsonl")
    ours = timeline.discover_artifacts(metrics)
    theirs = jax_timeline.discover_artifacts(metrics)
    assert timeline.build_timeline(ours) == jax_timeline.build_timeline(theirs)
    report = postmortem.build_report(ours)
    assert _without_ts(report) == _without_ts(jax_postmortem.build_report(theirs))
    assert report["exit_code"] == 0 and report["worlds"] == [2, 1]
    chain = next(c for c in report["recoveries"] if c["type"] == "relaunch")
    assert (chain["action"], chain["dead_ranks"], chain["new_world"]) == ("shrink", [1], 1)
    assert chain["saved_world"] == 2 and chain["trigger"] is not None
    assert 0 < chain["recovery_wall_s"] < 300
    assert any(t["step"] == chain["resume_step"] and t["world"] == 2
               for t in report["tier_steps"])
    assert any(r["rank"] == 1 for r in report["heartbeat_residue"])
    for budget in (None, 0.001):
        a = postmortem.build_report(ours, recovery_budget_s=budget)
        b = jax_postmortem.build_report(theirs, recovery_budget_s=budget)
        assert postmortem.render(a) == jax_postmortem.render(b)
    merged, jax_merged = tmp_path / "merged.json", tmp_path / "jax_merged.json"
    counts = timeline.merge_perfetto(ours["traces"], str(merged), records=ours["records"])
    assert counts == jax_timeline.merge_perfetto(theirs["traces"], str(jax_merged),
                                                 records=theirs["records"])
    lanes = {e["args"]["name"] for e in json.load(open(merged))
             if e.get("name") == "process_name"}
    assert {"attempt0/rank0", "attempt0/rank1", "attempt1/rank0"} <= lanes
    # The module's command line: exit 0 naming the chain, 1 past a budget.
    assert postmortem.main([str(drill["dir"])]) == 0
    text = capsys.readouterr().out
    assert "shrink" in text and "dead ranks [1]" in text and "saved_world=2" in text
    assert postmortem.main([str(drill["dir"]), "--json", "--recovery-budget-s", "0.001"]) == 1
    assert any("budget" in p for p in json.loads(capsys.readouterr().out)["problems"])


def _stream(path, records):
    with open(path, "w") as fh:
        for r in records:
            fh.write(json.dumps(r) + "\n")
    return str(path)


def _gap_streams(tmp_path):
    now = time.time()
    gap = _stream(tmp_path / "gap.jsonl", [
        {"ts": now - 60, "kind": "epoch", "epoch": 0, "train_loss": 0.5,
         "run_id": "r1", "attempt": 0},
        {"ts": now - 30, "kind": "epoch", "epoch": 1, "train_loss": 0.4,
         "run_id": "r1", "attempt": 2},
        {"ts": now - 10, "kind": "run_summary", "wall_s": 50.0, "exit_class": "ok",
         "run_id": "r1", "attempt": 2}])
    explained = _stream(tmp_path / "explained.jsonl", [
        {"ts": now - 60, "kind": "epoch", "epoch": 0, "train_loss": 0.5,
         "run_id": "r1", "attempt": 0},
        {"ts": now - 55, "kind": "fault", "fault": "hang", "run_id": "r1", "attempt": 0},
        {"ts": now - 50, "kind": "elastic_event", "event": "children_exited",
         "action": "shrink", "run_id": "r1", "attempt": 0},
        {"ts": now - 45, "kind": "elastic_event", "event": "shrink", "dead_ranks": [1],
         "new_world": 1, "run_id": "r1", "attempt": 0},
        {"ts": now - 40, "kind": "elastic_event", "event": "launch", "world": 1,
         "run_id": "r1", "attempt": 1},
        {"ts": now - 35, "kind": "recovery", "cause": "divergence", "retry": 1,
         "run_id": "r1", "attempt": 1},
        {"ts": now - 30, "kind": "epoch", "epoch": 1, "train_loss": 0.4,
         "run_id": "r1", "attempt": 1},
        {"ts": now - 20, "kind": "slo_violation", "slo": "recovery", "value": 20,
         "threshold": 5, "run_id": "r1", "attempt": 1},
        {"ts": now - 10, "kind": "run_summary", "wall_s": 50.0, "exit_class": "ok",
         "run_id": "r1", "attempt": 1}])
    pre_lineage = _stream(tmp_path / "plain.jsonl", [
        {"ts": now - 5, "kind": "epoch", "epoch": 0},
        {"ts": now - 1, "kind": "run_summary", "wall_s": 4.0, "exit_class": "ok"}])
    return {"gap": gap, "explained": explained, "plain": pre_lineage,
            "unreadable": str(tmp_path / "nowhere.jsonl")}


@pytest.mark.parametrize("stream", ["gap", "explained", "plain", "unreadable"])
def test_reports_on_hand_made_streams_equal_jax(tmp_path, stream):
    path = _gap_streams(tmp_path)[stream]
    records = timeline.read_records(path)
    assert records == jax_timeline.read_records(path)
    assert timeline.lineage_view(records) == jax_timeline.lineage_view(records)
    assert timeline.recoveries(records) == jax_timeline.recoveries(records)
    for budget in (None, 1.0):
        ours = postmortem.build_report(timeline.discover_artifacts(path),
                                       recovery_budget_s=budget)
        theirs = jax_postmortem.build_report(jax_timeline.discover_artifacts(path),
                                             recovery_budget_s=budget)
        assert _without_ts(ours) == _without_ts(theirs)
        assert postmortem.render(ours) == jax_postmortem.render(theirs)
    want = {"gap": 1, "explained": 1, "plain": 0, "unreadable": 2}[stream]
    assert ours["exit_code"] == want
    if stream == "gap":
        assert ours["unexplained"]
    if stream == "explained":
        assert ours["unexplained"] == [] and ours["slo_violations"] == 1


def test_flightrec_triggers_fill_a_silent_chain_like_jax():
    chains = [{"type": "relaunch", "from_attempt": 0, "to_attempt": 1, "trigger": None}]
    dumps = [{"rank": 1, "attempt": 1, "reason": "late", "events": []},
             {"rank": 0, "attempt": 0, "reason": "exception:RuntimeError",
              "dumped_ts": 5.0, "events": [{"kind": "fault", "fault": "exception",
                                             "ts": 4.0}]}]
    ours = timeline.attach_flightrec_triggers([dict(c) for c in chains], dumps)
    assert ours == jax_timeline.attach_flightrec_triggers([dict(c) for c in chains], dumps)
    assert ours[0]["trigger"]["rank"] == 0 and ours[0]["trigger"]["fault"] == "exception"


class _ListLogger:
    def __init__(self):
        self.records = []

    def log(self, kind, **fields):
        self.records.append({"kind": kind, **fields})


@pytest.mark.parametrize("attempt,decision,budget,seconds", [
    (1, "shrink", 120.0, 10.0), (1, "shrink", 5.0, 50.0), (0, "shrink", 1.0, 50.0),
    (1, "grow", 1.0, 50.0), (2, "restart", 5.0, 8.0)])
def test_recovery_slo_matches_jax(tmp_path, attempt, decision, budget, seconds):
    """The recovery objective across attempts: armed on a relaunch from the
    classification in the stream, one verdict at the first step, never on
    attempt 0 nor after a requested grow."""
    now = time.time()
    stream = _stream(tmp_path / "metrics.jsonl", [
        {"ts": now - 100, "kind": "epoch", "epoch": 0, "attempt": 0},
        {"ts": now - 70, "kind": "fault", "fault": "hang", "attempt": 0},
        {"ts": now - 50, "kind": "elastic_event", "event": "children_exited",
         "attempt": attempt - 1 if attempt else 0},
        {"ts": now - 49, "kind": "elastic_event", "event": decision,
         "attempt": attempt - 1 if attempt else 0}])
    out = {}
    for side, mod, lin in (("jax", jax_slo, jax_lineage), ("torch", slo, lineage)):
        prev = lin.current()
        lin.install(lin.Lineage(run_id="r", attempt=attempt))
        try:
            engine = mod.SloEngine(recovery_s=budget)
            log = _ListLogger()
            armed = engine.arm_recovery(stream)
            engine.note_training_step(logger=log, now=now - 50 + seconds)
            engine.note_training_step(logger=log, now=now + 1000)   # one verdict
            out[side] = (armed, engine.total_violations, log.records,
                         engine.objectives())
        finally:
            lin.install(prev) if prev else lin.uninstall()
    assert out["torch"] == out["jax"]
    armed, violations = out["torch"][:2]
    assert armed == (attempt > 0 and decision != "grow")
    assert violations == int(armed and seconds > budget)
