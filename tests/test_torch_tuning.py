"""PyTorch port: the signed tuning manifest (``tuning.py``) and the CLI's
startup hook, held against the JAX package's ``tuning.py``.

* the same manifests go through both packages' ``maybe_apply_manifest`` with
  an explicit ``environ`` and give the same decision record (or the same
  refusal): the repo's CPU manifest, arch and backend mismatches, a missing
  file under ``auto``, ``strict`` and the default path, a tampered digest, an
  unknown knob, and the precedence of a pre-set env gate and a user-set
  config key;
* ``tuning.apply=bogus`` raises in both ``load_config``;
* ``cli score --device cpu`` subprocesses: ``strict`` with a missing manifest
  exits 2 with ``[tuning]``; a matching manifest logs one ``tuning_applied``
  record (valid, and JAX's decision); a manifest pinning
  ``DDT_GRAND_FUSED=1`` with ``DDT_GRAND_BN_KERNEL=1`` fails with the gates'
  incompatibility error, so the gates were read after the hook;
* importing the port's CLI leaves ``ops/grand_batched.py`` unimported.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from data_diet_distributed_tpu import tuning as jax_tuning
from data_diet_distributed_tpu.config import load_config as jax_load_config
from data_diet_distributed_tpu_torch import tuning
from data_diet_distributed_tpu_torch.config import load_config
from torch_threads import SUBPROCESS_ENV

REPO = Path(__file__).resolve().parent.parent
REPO_MANIFEST = REPO / "artifacts" / "tuning_manifest.json"
GEOMETRY = ["data.dataset=synthetic", "model.arch=tiny_cnn", "score.batch_size=256"]


def _manifest(**over) -> dict:
    """The repo's CPU manifest with fields replaced, signed again."""
    body = json.loads(REPO_MANIFEST.read_text())
    geo = {**body["geometry"], **over.pop("geometry", {})}
    kw = dict(task=body["task"], method=body["method"], arch=geo["arch"],
              dataset=geo["dataset"], batch_size=geo["batch_size"],
              backend=body["backend"], device_kind=body["device_kind"],
              n_devices=body["n_devices"], env=body["env"], config=body["config"],
              chosen_combo=body["chosen_combo"], metric=body["metric"],
              value=body["value"], unit=body["unit"],
              baseline_value=body["baseline_value"], exactness=body["exactness"],
              candidates_considered=body["candidates_considered"])
    kw.update(over)
    return tuning.build_tuning_manifest(**kw)


def _write(path: Path, manifest: dict) -> str:
    path.write_text(json.dumps(manifest))
    return str(path)


def _decide(mod, load, overrides, environ):
    """``(decision, None)`` or ``(None, error message)`` of one package."""
    cfg = load(None, overrides)
    try:
        return mod.maybe_apply_manifest(cfg, backend="cpu", device_kind="cpu",
                                        environ=environ), None
    except mod.TuningError as err:
        return None, str(err)


def _tampered(tmp):
    m = _manifest()
    m["env"]["DDT_GRAND_FUSED"] = "1"          # edited after signing
    return _write(tmp / "m.json", m)


def _unknown_knob(tmp):
    m = _manifest()
    m["env"]["LD_PRELOAD"] = "/x.so"
    m["digest"] = tuning.manifest_digest(m)    # signed, but not allowed
    return _write(tmp / "m.json", m)


#: (case, how to make the manifest path (None = no override), extra
#: overrides, preset environ, working directory: repo root or an empty dir).
CASES = [
    ("repo_manifest_matches", lambda tmp: str(REPO_MANIFEST), [], {}, "tmp"),
    ("default_path_matches", None, [], {}, "repo"),
    ("default_path_absent", None, [], {}, "tmp"),
    ("arch_mismatch", lambda tmp: str(REPO_MANIFEST), ["model.arch=resnet18"], {}, "tmp"),
    ("backend_mismatch",
     lambda tmp: _write(tmp / "m.json", _manifest(backend="cuda",
                                                  device_kind="NVIDIA H100 80GB HBM3")),
     [], {}, "tmp"),
    ("missing_auto", lambda tmp: str(tmp / "absent.json"), [], {}, "tmp"),
    ("missing_strict", lambda tmp: str(tmp / "absent.json"), ["tuning.apply=strict"], {},
     "tmp"),
    ("default_path_strict", None, ["tuning.apply=strict"], {}, "tmp"),
    ("mismatch_strict", lambda tmp: str(REPO_MANIFEST),
     ["model.arch=resnet18", "tuning.apply=strict"], {}, "tmp"),
    ("off", lambda tmp: str(REPO_MANIFEST), ["tuning.apply='off'"], {}, "tmp"),
    ("tampered_digest", _tampered, [], {}, "tmp"),
    ("unknown_knob", _unknown_knob, [], {}, "tmp"),
    ("env_gate_preset_wins", lambda tmp: str(REPO_MANIFEST), [],
     {"DDT_GRAND_STEM_XLA": "0", "DDT_GRAND_FUSED": "0"}, "tmp"),
    ("user_config_wins", lambda tmp: str(REPO_MANIFEST), ["score.chunk_steps=4"], {}, "tmp"),
]


@pytest.mark.parametrize("case,path_of,extra,preset,cwd", CASES, ids=[c[0] for c in CASES])
def test_decision_record_matches_jax(tmp_path, monkeypatch, case, path_of, extra, preset,
                                     cwd):
    monkeypatch.chdir(REPO if cwd == "repo" else tmp_path)
    overrides = GEOMETRY + list(extra)
    if path_of is not None:
        overrides.append(f"tuning.manifest={path_of(tmp_path)}")
    env_port, env_jax = dict(preset), dict(preset)
    port = _decide(tuning, load_config, overrides, env_port)
    ref = _decide(jax_tuning, jax_load_config, overrides, env_jax)
    assert port == ref, (port, ref)
    assert env_port == env_jax
    decision, error = port
    if case.endswith("_matches"):
        assert decision["applied"] and decision["knobs"]["score.chunk_steps"] == 0
        assert env_port["DDT_GRAND_STEM_XLA"] == "1" and decision["skipped"] == {}
    elif case in ("default_path_absent", "off"):
        assert decision is None and error is None
    elif case.endswith("_strict") or case in ("tampered_digest", "unknown_knob"):
        assert decision is None and error
    elif case == "env_gate_preset_wins":
        assert decision["skipped"] == {"DDT_GRAND_STEM_XLA": "env", "DDT_GRAND_FUSED": "env"}
        assert env_port["DDT_GRAND_STEM_XLA"] == "0"
    elif case == "user_config_wins":
        assert decision["skipped"] == {"score.chunk_steps": "user-config"}
    else:
        assert decision["applied"] is False and decision["reason"] != "match"


def test_bogus_apply_mode_raises_in_both_packages():
    for load in (load_config, jax_load_config):
        with pytest.raises(ValueError, match="tuning.apply must be auto"):
            load(None, ["tuning.apply=bogus"])


def test_written_manifest_round_trips_and_refuses_unsigned(tmp_path):
    m = _manifest(env={"DDT_GRAND_BN_KERNEL": "1"}, config={})
    path = tuning.write_tuning_manifest(str(tmp_path / "m.json"), m)
    assert tuning.read_tuning_manifest(path) == m == jax_tuning.read_tuning_manifest(path)
    assert m["digest"] == jax_tuning.manifest_digest(m)
    with pytest.raises(tuning.TuningError, match="digest"):
        tuning.write_tuning_manifest(str(tmp_path / "u.json"), {**m, "value": 0.0})
    with pytest.raises(tuning.TuningError, match="not in the allowed set"):
        _manifest(env={"PATH": "/"})


# ------------------------------------------------------- the CLI's hook

def _tool(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CLI_GEOMETRY = ["data.dataset=synthetic", "data.synthetic_size=16", "model.arch=tiny_cnn",
                "score.batch_size=16", "score.pretrain_epochs=0", "score.method=grand",
                "train.half_precision=false"]


def _cli_env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DDT_") and k != "PYTHONPATH"}
    return {**env, **SUBPROCESS_ENV, "PYTHONPATH": str(REPO)}


def _cli_argv(tmp: Path, *over) -> list[str]:
    return ["score", "--device", "cpu", *CLI_GEOMETRY, f"train.checkpoint_dir={tmp}/ckpt",
            f"obs.metrics_path={tmp}/m.jsonl", *over]


def _cli_score(tmp: Path, *over):
    return subprocess.run(
        [sys.executable, "-m", "data_diet_distributed_tpu_torch.cli", *_cli_argv(tmp, *over)],
        cwd=str(tmp), env=_cli_env(), capture_output=True, text=True, timeout=120)


def _cli_manifest(tmp: Path, env: dict) -> str:
    m = _manifest(geometry={"batch_size": 16}, env=env, config={"score.chunk_steps": 0})
    return tuning.write_tuning_manifest(str(tmp / "manifest.json"), m)


@pytest.fixture(scope="module")
def strict_missing(tmp_path_factory):
    """One process: import the CLI, list the gated modules it imported, then
    run ``cli score`` under ``tuning.apply=strict`` with no manifest."""
    tmp = tmp_path_factory.mktemp("strict")
    code = ("import sys\n"
            "import data_diet_distributed_tpu_torch.cli as cli\n"
            "print(sorted(m for m in sys.modules if m.endswith(('grand_batched', "
            "'train.loop', 'serve.server'))), flush=True)\n"
            f"sys.exit(cli.main({_cli_argv(tmp, 'tuning.apply=strict')!r}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp), env=_cli_env(),
                         capture_output=True, text=True, timeout=120)
    return tmp, res


def test_cli_strict_missing_manifest_exits_2(strict_missing):
    tmp, res = strict_missing
    assert res.returncode == 2, res.stderr[-2000:]
    assert "[tuning] tuning.apply=strict but manifest" in res.stderr
    assert not (tmp / "ckpt_scores.npz").exists()


def test_cli_matching_manifest_logs_jax_decision(tmp_path):
    path = _cli_manifest(tmp_path, {"DDT_GRAND_STEM_XLA": "1", "DDT_GRAND_GROUP_BN": "0"})
    res = _cli_score(tmp_path, f"tuning.manifest={path}")
    assert res.returncode == 0, res.stderr[-2000:]
    vm = _tool("validate_metrics")
    assert vm.validate_file(str(tmp_path / "m.jsonl"), expect_terminal=True) == []
    recs = [json.loads(x) for x in open(tmp_path / "m.jsonl") if x.strip()]
    applied = [r for r in recs if r["kind"] == "tuning_applied"]
    assert len(applied) == 1
    ref = jax_tuning.maybe_apply_manifest(
        jax_load_config(None, CLI_GEOMETRY + [f"tuning.manifest={path}"]),
        backend="cpu", device_kind="cpu", environ={})
    assert {k: applied[0][k] for k in ref} == ref
    assert ref["applied"] and ref["knobs"]["DDT_GRAND_GROUP_BN"] == "0"


def test_cli_manifest_gates_are_read_after_the_hook(tmp_path):
    path = _cli_manifest(tmp_path, {"DDT_GRAND_FUSED": "1", "DDT_GRAND_BN_KERNEL": "1"})
    res = _cli_score(tmp_path, f"tuning.manifest={path}")
    assert res.returncode != 0
    assert "DDT_GRAND_FUSED=1/DDT_GRAND_MEGAKERNEL=1 is incompatible" in res.stderr, \
        res.stderr[-2000:]


def test_cli_import_leaves_the_gated_ops_unimported(strict_missing):
    _, res = strict_missing
    assert res.stdout.splitlines()[0] == "[]", res.stdout
