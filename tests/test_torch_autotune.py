"""PyTorch port: the card's tuner (``data_diet_distributed_tpu_torch.tools.autotune``
and ``.bisect_grand``), held against the JAX tools on the same inputs.

* the combo matrix (``COMBOS``, ``FAST``, ``_ALL_OFF``) equals
  ``tools/bisect_grand.py``'s;
* ``enumerate_candidates`` and ``ledger_negatives`` give the JAX tool's
  candidates, pruning and events on the same arguments and ledger records
  (the cases of ``tests/test_autotune.py``), the profile-seeded chunk arm
  included;
* ``main``, fed the same injected measure and verify results, writes a
  manifest equal to the JAX tool's field for field (``source``, ``backend``,
  ``device_kind`` and ``digest`` aside) and the same event sequence: a clean
  win, an inexact candidate skipped, the chunk arm's config knob, the
  confirmation, a dead backend, and no exact candidate (exit 2, no manifest);
* the real ``--verify-child`` in a subprocess on ``--device cpu``: ``ok`` for
  ``baseline`` and ``bn_kernel``, disqualified with exit 1 under
  ``DDT_AUTOTUNE_FAKE_INEXACT``;
* ``--measure-child`` on ``--device cpu``: one clean line and ledger record
  with the launches a batch.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import importlib.util
import io
import json
import subprocess
import sys
from pathlib import Path

import pytest

from data_diet_distributed_tpu_torch import tuning
from data_diet_distributed_tpu_torch.tools import autotune, bisect_grand
from data_diet_distributed_tpu_torch.tools import perf_sentry as ps
from torch_threads import SUBPROCESS_ENV, one_intra_op_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
TAIL = "grand_scoring_examples_per_sec_per_chip"
SHARED_ARGS = ["--task", "score", "--method", "grand", "--arch", "tiny_cnn",
               "--dataset", "synthetic", "--size", "256", "--batch", "64"]


def _jax_tool(name):
    if str(REPO / "tools") not in sys.path:
        # The JAX tools import their siblings (bisect_grand, perf_sentry) by name.
        sys.path.insert(0, str(REPO / "tools"))
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_autotune():
    return _jax_tool("autotune")


def _combo_rec(combo, value, **extra):
    return {"kind": "perf_history", "ts": 0.0, "source": "bench",
            "metric": f"autotune.{combo}.{TAIL}", "value": value,
            "unit": "examples/sec/chip", "exit_class": "ok", **extra}


def _events(path: Path) -> list[dict]:
    if not path.exists():
        return []
    return [{k: v for k, v in json.loads(ln).items() if k not in ("ts", "path", "digest")}
            for ln in path.read_text().splitlines()]


def _quiet(fn, *args, **kwargs):
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        return fn(*args, **kwargs)


def test_combo_matrix_is_the_jax_tools():
    jax_bisect = _jax_tool("bisect_grand")
    assert bisect_grand.COMBOS == jax_bisect.COMBOS
    assert bisect_grand.FAST == jax_bisect.FAST
    assert bisect_grand._ALL_OFF == jax_bisect._ALL_OFF
    assert bisect_grand._combo("BN_KERNEL", "CATDOT") == jax_bisect._combo("BN_KERNEL",
                                                                           "CATDOT")
    # autotune searches the same matrix.
    assert autotune.COMBOS is bisect_grand.COMBOS and autotune.FAST is bisect_grand.FAST


NEGATIVES = ([_combo_rec("baseline", 100.0) for _ in range(3)]
             + [_combo_rec("megakernel", 70.0) for _ in range(3)]
             + [_combo_rec("stem_xla", 105.0) for _ in range(3)])
BLIND = [_combo_rec("megakernel", 1.0)]
POISONED = ([_combo_rec("baseline", 100.0)] * 3
            + [_combo_rec("megakernel", 1.0, error="wedged")] * 3)
LOWER_BETTER = ([{**_combo_rec("baseline", 10.0), "unit": "seconds"}] * 2
                + [{**_combo_rec("fused", 12.0), "unit": "seconds"}] * 2)


@pytest.mark.parametrize("records", [NEGATIVES, BLIND, POISONED, LOWER_BETTER, []],
                         ids=["negatives", "blind", "poisoned", "seconds", "empty"])
@pytest.mark.parametrize("threshold", [0.10, 0.5])
def test_ledger_negatives_match_jax(jax_autotune, records, threshold):
    assert (autotune.ledger_negatives(records, TAIL, threshold)
            == jax_autotune.ledger_negatives(records, TAIL, threshold))


@pytest.mark.parametrize("extra,records,profile", [
    (["--no-profile"], NEGATIVES, None),
    (["--no-profile"], [], None),
    (["--combos", "baseline,stem_xla"], [], None),
    (["--full", "--no-profile"], NEGATIVES, None),
    (["--data-plane", "streaming", "--no-profile"], [], None),
    (["--task", "train", "--no-profile"], [], None),
    ([], [], 8),
    ([], [], 1),
    ([], NEGATIVES, None),
], ids=["negatives", "default", "combos", "full", "streaming", "train", "profile8",
        "profile1", "profile_failed"])
def test_enumeration_matches_jax(jax_autotune, monkeypatch, tmp_path, extra, records,
                                 profile):
    """The same candidates (name, env, extra) in the same order, and the same
    pruned_negative / profile_seed events."""
    for mod in (jax_autotune, autotune):
        monkeypatch.setattr(mod, "profile_chunk_recommendation", lambda args: profile)
    argv = SHARED_ARGS + extra
    tail = TAIL if "train" not in extra else "train_examples_per_sec_per_chip"
    got = {}
    for name, mod in (("jax", jax_autotune), ("port", autotune)):
        ev = tmp_path / f"{name}.jsonl"
        cands = _quiet(mod.enumerate_candidates, mod.build_parser().parse_args(argv),
                       records, tail, str(ev))
        got[name] = (cands, _events(ev))
    assert got["port"] == got["jax"]
    names = [c["name"] for c in got["port"][0]]
    if records is NEGATIVES and "--combos" not in extra:
        assert "megakernel" not in names and "baseline" in names
    if profile == 8:
        assert "profile_chunk8" in names


def test_unknown_combo_refused_as_jax(jax_autotune):
    msgs = []
    for mod in (jax_autotune, autotune):
        with pytest.raises(SystemExit) as exc:
            mod.enumerate_candidates(mod.build_parser().parse_args(
                SHARED_ARGS + ["--combos", "baseline,nope"]), [], TAIL)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1] and "unknown --combos" in msgs[0]


def _verify_report(ok: bool, err: float) -> dict:
    return {"ok": ok, "reference": "grand_vmap", "max_abs_err": err,
            "max_rel_err": err * 10, "rtol": 2e-4, "atol": 1e-5,
            "backend": "cpu", "device_kind": "cpu", "n_devices": 1}


# (combos, measured values by combo (None: an error line), verify ok by combo,
#  confirm).
MAIN_CASES = {
    "clean_win": ("baseline,stem_xla", {"baseline": 100.0, "stem_xla": 130.0},
                  {"baseline": True, "stem_xla": True}, False),
    "inexact_skipped": ("baseline,stem_xla,megakernel",
                        {"baseline": 100.0, "stem_xla": 130.0, "megakernel": 150.0},
                        {"baseline": True, "stem_xla": True, "megakernel": False}, False),
    "chunk_knob": ("baseline,stem_xla+chunk0", {"baseline": 100.0, "stem_xla+chunk0": 110.0},
                   {"baseline": True, "stem_xla+chunk0": True}, False),
    "failed_measure": ("baseline,bn_kernel", {"baseline": 100.0, "bn_kernel": None},
                       {"baseline": True, "bn_kernel": True}, False),
    "confirmed": ("baseline,bn_kernel", {"baseline": 100.0, "bn_kernel": 125.0},
                  {"baseline": True, "bn_kernel": True}, True),
    "no_exact": ("baseline,stem_xla", {"baseline": 100.0, "stem_xla": 130.0},
                 {"baseline": False, "stem_xla": False}, False),
    "dead_backend": ("baseline,stem_xla", {"baseline": "backend", "stem_xla": 130.0},
                     {"baseline": True, "stem_xla": True}, False),
}


def _line(name: str, value) -> dict:
    if value is None:
        return {"error": "combo crashed"}
    if value == "backend":
        return {"error": "backend unavailable"}
    return {"metric": f"autotune.{name}.{TAIL}", "value": value,
            "unit": "examples/sec/chip"}


@pytest.mark.parametrize("case", sorted(MAIN_CASES))
def test_main_matches_jax(jax_autotune, monkeypatch, tmp_path, case):
    combos, values, exact, confirm = MAIN_CASES[case]
    confirm_line = {"metric": TAIL, "value": 123.0, "unit": "examples/sec/chip"}

    def runner(cand):
        return _verify_report(exact[cand["name"]], 1e-7 if exact[cand["name"]] else 0.01)

    def port_measure(args, cand, events_path=None, *, combo_flag=True):
        return _line(cand["name"], values[cand["name"]]) if combo_flag else confirm_line

    def jax_measure(args, cand, events_path=None):
        return _line(cand["name"], values[cand["name"]])

    def jax_confirm(cmd, **kwargs):   # the JAX tool's confirmation subprocess
        return subprocess.CompletedProcess(cmd, 0, json.dumps(confirm_line) + "\n", "")

    monkeypatch.setattr(autotune, "measure_candidate", port_measure)
    monkeypatch.setattr(jax_autotune, "measure_candidate", jax_measure)
    monkeypatch.setattr(jax_autotune.subprocess, "run", jax_confirm)
    results = {}
    for name, mod in (("jax", jax_autotune), ("port", autotune)):
        monkeypatch.setattr(mod, "verify_candidate",
                            functools.partial(mod.verify_candidate, runner=runner))
        out, ev = tmp_path / f"{name}.json", tmp_path / f"{name}_events.jsonl"
        argv = SHARED_ARGS + ["--combos", combos, "--out", str(out), "--events", str(ev),
                              "--ledger", str(tmp_path / "none.jsonl")]
        if not confirm:
            argv.append("--no-confirm")
        if mod is autotune:
            argv += ["--device", "cpu"]
        rc = _quiet(mod.main, argv)
        manifest = tuning.read_tuning_manifest(str(out)) if out.exists() else None
        results[name] = (rc, _events(ev), manifest)
    (rc_j, ev_j, man_j), (rc_p, ev_p, man_p) = results["jax"], results["port"]
    assert rc_p == rc_j
    assert ev_p == ev_j
    if case in ("no_exact", "dead_backend"):
        assert rc_p == 2 and man_p is None and man_j is None
        assert ev_p[-1]["event"] == ("no_exact_candidate" if case == "no_exact"
                                     else "abort_backend")
        return
    assert rc_p == 0
    skip = ("source", "backend", "device_kind", "digest")
    assert {k: v for k, v in man_p.items() if k not in skip} == \
        {k: v for k, v in man_j.items() if k not in skip}
    assert man_p["source"] == autotune.SOURCE
    assert len([k for k in man_p["env"] if k.startswith("DDT_GRAND_")]) == 7
    if case == "inexact_skipped":
        assert [e["event"] for e in ev_p if e["event"] in ("disqualified", "verified")] == \
            ["disqualified", "verified"]
        assert man_p["chosen_combo"] == "stem_xla"
    if case == "chunk_knob":
        assert man_p["config"] == {"score.chunk_steps": 0}
    if case == "confirmed":
        assert ev_p[-1]["event"] == "confirmed" and ev_p[-1]["value"] == 123.0


def _verify_args() -> argparse.Namespace:
    return argparse.Namespace(arch="tiny_cnn", method="grand", verify_batch=4,
                              grand_chunk=2, device="cpu", timeout=240)


CHILD = [sys.executable, "-m", "data_diet_distributed_tpu_torch.tools.autotune"]
VERIFY = {"baseline": ((), False), "bn_kernel": (("BN_KERNEL",), False),
          "fake_inexact": ((), True)}


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """The real children on the CPU, started at once: the three verify
    children of ``VERIFY`` and one measure child. Returns ``{name: (rc,
    stdout, stderr)}`` and the measure child's ledger path."""
    root = tmp_path_factory.mktemp("children")
    ledger = root / "ledger.jsonl"
    cmds = {}
    for name, (on, fake) in VERIFY.items():
        env = {**bisect_grand._combo(*on), **SUBPROCESS_ENV}
        if fake:
            env["DDT_AUTOTUNE_FAKE_INEXACT"] = "1"
        cmds[name] = (CHILD + ["--verify-child", "--arch", "tiny_cnn", "--method", "grand",
                               "--verify-batch", "4", "--grand-chunk", "2",
                               "--device", "cpu"], env)
    cmds["measure"] = (CHILD + ["--measure-child", "--task", "score", "--method", "el2n",
                                "--arch", "tiny_cnn", "--size", "64", "--batch", "32",
                                "--repeats", "1", "--seeds", "2", "--ledger", str(ledger),
                                "--device", "cpu", "--autotune-combo", "baseline"],
                       {**bisect_grand._combo(), **SUBPROCESS_ENV})
    procs = {name: subprocess.Popen(cmd, env=autotune._child_env(env), cwd=root,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)
             for name, (cmd, env) in cmds.items()}
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=240)
        out[name] = (proc.returncode, stdout, stderr)
    return out, ledger


@pytest.mark.parametrize("combo", sorted(VERIFY))
def test_verify_child_subprocess(children, tmp_path, combo):
    """The real child on the CPU: the production ``grand`` route against
    ``grand_vmap`` at the pinned tolerances, under the combo's gates."""
    rc, stdout, stderr = children[0][combo]
    ok = not VERIFY[combo][1]
    report = json.loads(stdout.splitlines()[-1])
    assert report["ok"] is ok and rc == (0 if ok else 1), stderr[-2000:]
    assert (report["backend"], report["device_kind"], report["n_devices"]) == ("cpu", "cpu", 1)
    assert report["reference"] == "grand_vmap"
    if ok:
        assert report["max_abs_err"] <= 1e-5 + 2e-4 * 10
    else:
        assert report["max_abs_err"] > 2e-4
        events = tmp_path / "events.jsonl"
        cand = {"name": combo, "env": {}, "extra": []}
        assert _quiet(autotune.verify_candidate, _verify_args(), cand, str(events),
                      runner=lambda c: report)["ok"] is False
        assert _events(events)[-1]["event"] == "disqualified"


def test_measure_child_line_and_ledger(children):
    """One tiny CPU measurement: a clean line with the launches a batch (the
    plain route launches no kernel), its ledger record judged clean by the
    sentry."""
    (rc, stdout, stderr), ledger = children[0]["measure"], children[1]
    assert rc == 0, stderr[-2000:]
    line = json.loads(stdout.splitlines()[-1])
    assert line["metric"] == "autotune.baseline.el2n_scoring_examples_per_sec_per_chip"
    assert line["value"] > 0 and line["exit_class"] == "ok"
    assert (line["backend"], line["device_kind"]) == ("cpu", "cpu")
    assert line["chunk_steps"] == 2    # two seeds: resident, the whole epoch a dispatch
    assert line["launches_per_batch"]["el2n"] == 0.0
    [rec] = ps.load_ledger(str(ledger))
    assert ps.classify_record(rec) == ps.CLEAN and ps.autotune_combo(rec) == "baseline"
    assert rec["geometry"]["seeds"] == 2 and rec["backend"] == "cpu"
    assert rec["launches_per_batch"] == line["launches_per_batch"]
