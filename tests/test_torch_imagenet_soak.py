"""PyTorch port: the ImageNet-scale soak driver
(``data_diet_distributed_tpu_torch.tools.imagenet_soak``).

* ``generate`` at 64 rows, 16x16, 10 classes writes the JAX tool's
  (``tools/imagenet_soak.py``, loaded by path; its module level imports no
  JAX) ``.npy`` files byte for byte, and ``stats.npz`` with the same members;
* the fault plans and schedules equal the JAX tool's;
* the ingestion mode at a tiny size (tiny CNN, 256 rows) prints the keys of
  the JAX tool's JSON line, with finite rates and the CPU named;
* one supervised ``--smoke --schedule sigterm --device cpu`` cycle is judged
  healthy by the port's monitor, validator and post-mortem;
* ``--help`` runs with JAX and the JAX package unimportable, and without a
  card ``--device cuda`` (the default) exits non-zero.

The whole smoke schedule runs on the card, in ``chip_smoke.py``'s soak phase.
"""

from __future__ import annotations

import ast
import contextlib
import importlib.util
import io
import json
import math
import os
import subprocess
import sys
import zipfile
from pathlib import Path

import pytest

from data_diet_distributed_tpu_torch.tools import imagenet_soak
from data_diet_distributed_tpu_torch.tools.validate_metrics import validate_file
from torch_threads import SUBPROCESS_ENV, one_intra_op_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
JAX_TOOL = REPO / "tools" / "imagenet_soak.py"


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location("jax_tool_imagenet_soak", JAX_TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _npz_members(path) -> dict[str, bytes]:
    with zipfile.ZipFile(path) as zf:
        return {name: zf.read(name) for name in zf.namelist()}


def test_generate_writes_the_jax_tools_bytes(jax_tool, tmp_path):
    imagenet_soak.generate(str(tmp_path / "port"), 64, 16, 10, 0)
    jax_tool.generate(str(tmp_path / "jax"), 64, 16, 10, 0)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [
        "stats.npz", "test_images.npy", "test_labels.npy", "train_images.npy",
        "train_labels.npy"]
    for name in names:
        if name.endswith(".npy"):
            assert (tmp_path / "port" / name).read_bytes() \
                == (tmp_path / "jax" / name).read_bytes(), name
    # A zip entry carries its write time: the members are compared.
    assert _npz_members(tmp_path / "port" / "stats.npz") \
        == _npz_members(tmp_path / "jax" / "stats.npz")


@pytest.mark.parametrize("name", ["FAULTS", "SMOKE_SCHEDULE", "SMOKE_STREAMING_SCHEDULE",
                                  "SOAK_SCHEDULE"])
def test_fault_constants_match(jax_tool, name):
    assert getattr(imagenet_soak, name) == getattr(jax_tool, name)


def _jax_line_keys() -> list[str]:
    """The keys of the JSON line the JAX tool's ingestion mode prints (the
    last ``json.dumps({...})`` of its ``main``), read from its source."""
    main = next(node for node in ast.parse(JAX_TOOL.read_text()).body
                if isinstance(node, ast.FunctionDef) and node.name == "main")
    dumps = [node for node in ast.walk(main)
             if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dumps"
             and node.args and isinstance(node.args[0], ast.Dict)]
    return [k.value for k in max(dumps, key=lambda n: n.lineno).args[0].keys]


def _run_tool(args: list[str], cwd) -> subprocess.CompletedProcess:
    """``python -m`` the tool in a process of its own, as it is run: its
    passes and its supervisor install process-wide state (the scoreboard, a
    run lineage) that must not reach the other tests of this worker."""
    env = {**os.environ, **SUBPROCESS_ENV,
           "PYTHONPATH": os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")])}
    env.pop("DDT_FAULT_PLAN", None)
    return subprocess.run(
        [sys.executable, "-m", "data_diet_distributed_tpu_torch.tools.imagenet_soak", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=240)


def test_ingestion_prints_the_jax_tools_keys(tmp_path):
    data = str(tmp_path / "data")
    proc = _run_tool(["--device", "cpu", "--arch", "tiny_cnn", "--rows", "256",
                      "--image-size", "16", "--classes", "10", "--batch", "64",
                      "--score-rows", "128", "--data-dir", data], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(line) == _jax_line_keys()
    assert line["rows"] == 256 and line["score_rows"] == 128 and line["image_size"] == 16
    assert line["platform"] == "cpu" and line["n_devices"] == 1
    assert line["generate_s"] is not None and line["score_method"] == "el2n"
    for key in ("ingest_examples_per_s", "ingest_gb_per_s", "score_examples_per_s",
                "rss_anon_peak_mb", "scores_mean"):
        assert math.isfinite(line[key]) and line[key] > 0, key
    assert line["rss_anon_peak_mb"] >= line["rss_anon_start_mb"]
    assert "anonymous RSS from ('/proc/self/" in proc.stderr
    # The data is there now: a second run with another geometry is refused.
    with pytest.raises(SystemExit, match="delete the dir"):
        imagenet_soak.main(["--device", "cpu", "--rows", "512", "--image-size", "16",
                            "--classes", "10", "--data-dir", data])


def test_supervised_sigterm_cycle_is_healthy(tmp_path):
    workdir = tmp_path / "soak"
    proc = _run_tool(["--device", "cpu", "--smoke", "--schedule", "sigterm",
                      "--workdir", str(workdir), "--quiet"], tmp_path)
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert proc.returncode == 0 and report["ok"] is True, proc.stdout[-3000:]
    assert report["faults"] == ["sigterm"] and report["recovered"] == 1
    assert report["monitor_exits"] == [0] and report["postmortem_exits"] == [0]
    (cycle,) = report["per_cycle"]
    # The SIGTERM went through the supervisor: the worker exited 75 and was
    # relaunched, and the post-mortem explains the one relaunch.
    assert cycle["attempts"] == 2 and cycle["exit_class"] == "ok"
    assert cycle["elastic_events"] == ["supervise", "launch", "children_exited", "restart",
                                       "launch", "children_exited", "complete"]
    assert cycle["slo"]["ok"] is True and cycle["stream_problems"] == []
    (chain,) = cycle["postmortem"]["recoveries"]
    assert chain["type"] == "relaunch" and chain["explained"] is True
    assert chain["trigger"]["signal"] == "SIGTERM"
    soak_stream = workdir / "soak.jsonl"
    assert validate_file(str(soak_stream)) == []
    kinds = [json.loads(line)["kind"] for line in open(soak_stream)]
    assert kinds == ["elastic_event", "postmortem_report", "soak_report"]


def test_help_without_jax(tmp_path):
    code = ("import runpy, sys\n"
            "for m in ('jax', 'data_diet_distributed_tpu'):\n"
            "    sys.modules[m] = None\n"
            "sys.argv = ['imagenet_soak', '--help']\n"
            "runpy.run_module('data_diet_distributed_tpu_torch.tools.imagenet_soak', "
            "run_name='__main__')\n")
    env = {**os.environ, **SUBPROCESS_ENV,
           "PYTHONPATH": os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "--device" in proc.stdout and "--smoke" in proc.stdout


@pytest.mark.parametrize("argv", [[], ["--smoke"]])
def test_cuda_without_a_card_exits_nonzero(tmp_path, argv):
    """Both modes on this box's default device: a non-zero exit naming
    ``--device cpu`` before anything is written."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is then valid")
    out = io.StringIO()
    with pytest.raises(SystemExit) as exc, contextlib.redirect_stdout(out):
        imagenet_soak.main(argv + ["--data-dir", str(tmp_path / "data"),
                                   "--workdir", str(tmp_path / "wd")])
    assert exc.value.code not in (0, None) and "--device cpu" in str(exc.value.code)
    assert out.getvalue() == "" and sorted(os.listdir(tmp_path)) == []
