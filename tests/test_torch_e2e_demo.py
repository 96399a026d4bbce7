"""PyTorch port: the prune demo (``data_diet_distributed_tpu_torch.tools.e2e_demo``).

* The demo end to end on the CPU (tiny CNN, 256 examples, one epoch, sparsity
  0.5): the dense, hardest and random rows, half the set kept by both
  policies, the random sweep on the hardest sweep's scores;
* the JAX tool (``tools/e2e_demo.py``), fed the same three metrics streams in
  place of its own CLI runs, writes the same rows and the same headline;
* the port's ``select_indices`` on the hardest sweep's scores equals the JAX
  package's ``pruning.select_indices`` for ``hardest`` and for ``random`` with
  the sweep's seed, and both equal the kept sets the sweeps wrote;
* without a card, ``--device cuda`` (the default) exits non-zero; ``--help``
  runs with JAX and the JAX package unimportable, which proves the driver
  imports neither.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from data_diet_distributed_tpu import pruning as jax_pruning
from data_diet_distributed_tpu_torch import pruning
from data_diet_distributed_tpu_torch.config import load_config
from data_diet_distributed_tpu_torch.tools import e2e_demo
from torch_threads import SUBPROCESS_ENV, one_intra_op_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
ARGS = ["--device", "cpu", "--arch", "tiny_cnn", "--size", "256", "--epochs", "1",
        "--pretrain-epochs", "1", "--sparsities", "0.5", "--batch", "64"]
STREAMS = ("metrics_dense.jsonl", "metrics_hard.jsonl", "metrics_rand.jsonl")
#: What the headline's keys and values name outside the run itself.
PATH_KEYS = ("summary", "plot", "total_wall_s")


def _rows(summary: str) -> tuple[dict, list[dict]]:
    with open(summary) as fh:
        config, *rows = [json.loads(line) for line in fh]
    return config, rows


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    root = tmp_path_factory.mktemp("demo")
    argv = ARGS + ["--workdir", str(root / "wd"), "--out", str(root / "out")]
    with pytest.MonkeyPatch.context() as mp:
        for k, v in SUBPROCESS_ENV.items():
            mp.setenv(k, v)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            headline = e2e_demo.main(argv)
    assert out.getvalue().strip().splitlines()[-1] == json.dumps(headline)
    return {"root": root, "wd": root / "wd", "headline": headline}


def test_demo_rows_and_reuse(demo):
    config, rows = _rows(demo["headline"]["summary"])
    assert config["kind"] == "config" and config["device"] == "cpu"
    assert [(r["keep"], r["sparsity"]) for r in rows] == [
        ("dense", 0.0), ("hardest", 0.5), ("random", 0.5)]
    dense, hard, rand = rows
    assert hard["n_kept"] == rand["n_kept"] == 128
    assert hard["score_method"] == "el2n"
    assert rand["score_method"] == f"reused:{demo['wd']}/hard_s0p5_scores.npz"
    assert all(0.0 <= r["final_test_accuracy"] <= 1.0 for r in rows)
    assert hard["train_wall_s"] > 0 and rand["train_wall_s"] > 0
    h = demo["headline"]
    assert h["dense_accuracy"] == dense["final_test_accuracy"]
    assert h["hardest@0.5"] == hard["final_test_accuracy"]
    assert h["random@0.5"] == rand["final_test_accuracy"]
    # The random sweep scored nothing: it loaded the hardest sweep's scores.
    with open(demo["wd"] / "metrics_rand.jsonl") as fh:
        kinds = [json.loads(line)["kind"] for line in fh if line.startswith("{")]
    assert "scores_loaded" in kinds and "score_stats" not in kinds


def test_jax_tool_writes_the_same_rows_and_headline(demo, tmp_path, monkeypatch):
    """The JAX tool's assembly over the port's three streams: each of its CLI
    runs is replaced by a copy of the port leg's stream."""
    spec = importlib.util.spec_from_file_location("jax_tool_e2e_demo",
                                                  REPO / "tools" / "e2e_demo.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    legs = iter(STREAMS)
    seen = []

    def run_cli(command, overrides, env, timeout):
        stream = next(legs)
        dst = next(o.split("=", 1)[1] for o in overrides
                   if o.startswith("obs.metrics_path="))
        assert os.path.basename(dst) == stream
        shutil.copyfile(demo["wd"] / stream, dst)
        seen.append(command)

    monkeypatch.setattr(tool, "run_cli", run_cli)
    jax_args = [a for a in ARGS if a not in ("--device", "cpu")]
    monkeypatch.setattr(sys, "argv", ["e2e_demo.py", "--platform", "cpu", *jax_args,
                                      "--workdir", str(tmp_path / "wd"),
                                      "--out", str(tmp_path / "out")])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tool.main()
    jax_headline = json.loads(out.getvalue().strip().splitlines()[-1])
    assert seen == ["train", "sweep", "sweep"]
    port = demo["headline"]
    assert list(port) == list(jax_headline)
    assert {k: v for k, v in port.items() if k not in PATH_KEYS} \
        == {k: v for k, v in jax_headline.items() if k not in PATH_KEYS}
    for k in ("summary", "plot"):
        assert (port[k] is None) == (jax_headline[k] is None)
        if port[k] is not None:
            assert os.path.basename(port[k]) == os.path.basename(jax_headline[k])
    port_config, port_rows = _rows(port["summary"])
    jax_config, jax_rows = _rows(jax_headline["summary"])
    # The port's reuse path names its own workdir; the JAX tool's rows carry
    # the same string (it read the port's streams).
    assert port_rows == jax_rows
    assert set(port_config) - {"device"} == set(jax_config) - {"platform"}


def test_jax_tool_overrides_match(demo, tmp_path, monkeypatch):
    """Each leg's overrides are the JAX tool's, in order, with the port's
    ``--device`` after them."""
    spec = importlib.util.spec_from_file_location("jax_tool_e2e_demo_o",
                                                  REPO / "tools" / "e2e_demo.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    jax_legs, port_legs = [], []

    def jax_run(command, overrides, env, timeout):
        jax_legs.append((command, overrides))
        for o in overrides:
            if o.startswith("obs.metrics_path="):
                shutil.copyfile(demo["wd"] / os.path.basename(o.split("=", 1)[1]),
                                o.split("=", 1)[1])

    def port_run(command, overrides, device, workdir, env, timeout):
        port_legs.append((command, overrides + ["--device", device]))
        for o in overrides:
            if o.startswith("obs.metrics_path="):
                shutil.copyfile(demo["wd"] / os.path.basename(o.split("=", 1)[1]),
                                o.split("=", 1)[1])

    monkeypatch.setattr(tool, "run_cli", jax_run)
    monkeypatch.setattr(e2e_demo, "run_cli", port_run)
    wd = tmp_path / "wd"
    jax_args = [a for a in ARGS if a not in ("--device", "cpu")]
    monkeypatch.setattr(sys, "argv", ["e2e_demo.py", "--platform", "cpu", *jax_args,
                                      "--workdir", str(wd), "--out", str(tmp_path / "j")])
    with contextlib.redirect_stdout(io.StringIO()):
        tool.main()
        e2e_demo.main(ARGS + ["--workdir", str(wd), "--out", str(tmp_path / "p")])
    assert [(c, o + ["--device", "cpu"]) for c, o in jax_legs] == port_legs


@pytest.mark.parametrize("keep", ["hardest", "random"])
def test_select_indices_match_jax(demo, keep):
    with np.load(demo["wd"] / "hard_s0p5_scores.npz") as f:
        scores, indices, kept_hard = f["scores"], f["indices"], f["kept"]
    seed = load_config(None, []).train.seed
    got = pruning.select_indices(scores, indices, 0.5, keep=keep, seed=seed)
    want = jax_pruning.select_indices(scores, indices, 0.5, keep=keep, seed=seed)
    np.testing.assert_array_equal(got, want)
    assert len(got) == 128
    if keep == "hardest":
        np.testing.assert_array_equal(got, kept_hard)
    else:
        with np.load(demo["wd"] / "rand_s0p5_scores.npz") as f:
            np.testing.assert_array_equal(f["scores"], scores)
            np.testing.assert_array_equal(got, f["kept"])


#: ``python -m <tool> --help`` with JAX and the JAX package unimportable.
HELP_WITHOUT_JAX = ("import runpy, sys\n"
                    "for m in ('jax', 'data_diet_distributed_tpu'):\n"
                    "    sys.modules[m] = None\n"
                    "sys.argv = [sys.argv[1], '--help']\n"
                    "runpy.run_module(sys.argv[0], run_name='__main__')\n")


def test_help_without_jax(tmp_path):
    env = {**os.environ, **SUBPROCESS_ENV,
           "PYTHONPATH": os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run([sys.executable, "-c", HELP_WITHOUT_JAX,
                           "data_diet_distributed_tpu_torch.tools.e2e_demo"],
                          cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "--device" in proc.stdout and "--sparsities" in proc.stdout


def test_cuda_without_a_card_exits_nonzero(tmp_path):
    """The default device on this box: a non-zero exit naming ``--device
    cpu`` before any child starts or any file is written."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is then valid")
    out = io.StringIO()
    with pytest.raises(SystemExit) as exc, contextlib.redirect_stdout(out):
        e2e_demo.main(["--workdir", str(tmp_path / "wd"), "--out", str(tmp_path / "out")])
    assert exc.value.code not in (0, None) and "--device cpu" in str(exc.value.code)
    assert out.getvalue() == "" and sorted(os.listdir(tmp_path)) == []
