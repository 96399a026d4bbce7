"""PyTorch port: the dispatch profiler and the duty validator
(``data_diet_distributed_tpu_torch.tools.profile_dispatch`` and
``.validate_duty``), and the device rule of every new card tool.

* ``recommend`` and the printed report equal ``tools/profile_dispatch.py``'s
  ``_report`` over a grid of (t1, tl, k_long, frac, clamp), the devices line
  aside;
* a tiny ``--device cpu`` run of the profiler (score and train chunks) prints
  the report, and one of the duty validator prints the JAX tool's keys with
  every duty null (the CPU has no device to probe);
* each tool imports without JAX and without the repo's ``tools/``, and each
  tool that runs on a device exits non-zero on this GPU-less box without
  ``--device cpu``, writing nothing, instead of running on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from data_diet_distributed_tpu_torch.tools import profile_dispatch, validate_duty
from torch_threads import SUBPROCESS_ENV, one_intra_op_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
NEW_TOOLS = ("perf_sentry", "bisect_grand", "profile_dispatch", "autotune", "validate_duty")
DEVICE_TOOLS = {   # tool -> tiny arguments; perf_sentry reads files and uses no device
    "bisect_grand": ["--fast", "--size", "64", "--batch", "32", "--out", "bisect.json"],
    "profile_dispatch": ["--task", "score", "--arch", "tiny_cnn", "--batch", "8"],
    "autotune": ["--arch", "tiny_cnn", "--size", "64", "--batch", "32", "--out", "m.json",
                 "--events", "ev.jsonl", "--ledger", "ledger.jsonl"],
    "validate_duty": ["--idle-s", "0.1", "--busy-s", "0.1", "--dim", "16",
                      "--out", "duty.json"],
}


@pytest.fixture(scope="module")
def jax_report():
    spec = importlib.util.spec_from_file_location("jax_tool_profile_dispatch",
                                                  REPO / "tools" / "profile_dispatch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._report


def _printed(fn, *args) -> tuple[object, list[str]]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = fn(*args)
    return ret, out.getvalue().splitlines()


GRID = [(t1, tl, k, frac, clamp)
        for t1, tl in ((0.030, 0.100), (0.025, 0.055), (0.0012, 0.0190), (0.010, 0.100),
                       (0.050, 0.040), (0.020, 0.020), (0.020, 0.30), (1e-4, 1.6e-3))
        for k in (2, 16) for frac in (0.05, 0.01) for clamp in (32, 64)]


@pytest.mark.parametrize("t1,tl,k_long,frac,clamp", GRID)
def test_recommend_matches_jax_report(jax_report, t1, tl, k_long, frac, clamp):
    args = argparse.Namespace(task="score", arch="resnet18", k_long=k_long, frac=frac)
    _, jax_lines = _printed(jax_report, args, "score.chunk_steps", "batch", t1, tl, 512,
                            clamp)
    got, lines = _printed(profile_dispatch.report, args, "score.chunk_steps", "batch", t1,
                          tl, 512, clamp, "cpu")
    assert lines[1:] == jax_lines[1:]
    assert lines[0] == "task=score arch=resnet18 batch=512 devices=1 (cpu)"
    m = re.search(r"recommended \S+ >= (\d+)", jax_lines[-1])
    assert got["recommended"] == (int(m.group(1)) if m else None)
    assert got == {"t1": t1, "tl": tl, **profile_dispatch.recommend(t1, tl, k_long, frac,
                                                                    clamp)}


@pytest.mark.parametrize("task,label", [("score", "score.chunk_steps"),
                                        ("train", "train.chunk_steps")])
def test_profile_dispatch_on_the_cpu(task, label):
    """Both chunk programs, timed through the chunked engine on the CPU: the
    report's lines, a positive per-step time, the label the tuner parses."""
    r, lines = _printed(profile_dispatch.main, [
        "--device", "cpu", "--task", task, "--arch", "tiny_cnn", "--batch", "8",
        "--k-long", "3", "--reps", "2", "--no-half"])
    assert lines[0] == f"task={task} arch=tiny_cnn batch=8 devices=1 (cpu)"
    assert lines[1].startswith("t(1)") and lines[2].startswith("t(3 )")
    assert lines[4].startswith("per-dispatch overhead")
    assert f"{r['t1'] * 1e3:8.2f} ms" in lines[1]
    if r["recommended"] is None:
        assert "chunking buys nothing" in lines[-1] and label in lines[-1]
    else:
        assert re.fullmatch(rf"recommended {re.escape(label)} >= {r['recommended']} .*",
                            lines[-1])
    assert set(r) == {"t1", "tl", "t_step", "overhead", "recommended"}
    assert r["t1"] > 0 and r["tl"] > 0


def test_profile_dispatch_refusals():
    with pytest.raises(SystemExit, match="no chunk across ranks"):
        profile_dispatch.main(["--device", "cpu", "--nproc", "2"])
    with pytest.raises(SystemExit, match="no chunk across ranks"):
        profile_dispatch.main(["--device", "cpu", "--sharded-update"])
    with pytest.raises(SystemExit, match="needs >= --k-long"):
        profile_dispatch.main(["--device", "cpu", "--task", "score", "--arch", "tiny_cnn",
                               "--batch", "8", "--size", "16", "--k-long", "4"])


def test_validate_duty_on_the_cpu(tmp_path):
    out = tmp_path / "duty.json"
    result, lines = _printed(validate_duty.main, [
        "--device", "cpu", "--idle-s", "0.3", "--busy-s", "0.6", "--dim", "16",
        "--out", str(out)])
    jax_keys = {"n_samples", "devices", "platform", "duty_idle_pre", "duty_busy",
                "duty_idle_post", "per_device_busy"}
    assert jax_keys <= set(result) and result["platform"] == "cpu"
    assert result["n_samples"] > 0 and result["devices"] == 1
    assert result["duty_idle_pre"] is result["duty_busy"] is result["duty_idle_post"] is None
    assert all(d is None for d in result["per_device_busy"])
    assert out.read_text().strip() == lines[-1]


@pytest.mark.parametrize("name", NEW_TOOLS)
def test_tools_import_without_jax(name):
    """Each new module imports, and its source imports no JAX."""
    mod = importlib.import_module(f"data_diet_distributed_tpu_torch.tools.{name}")
    with open(mod.__file__) as fh:
        src = fh.read()
    banned = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|oracle|"
                        r"data_diet_distributed_tpu)\b(?!_torch)", re.M)
    assert not banned.search(src)


def test_port_and_chip_smoke_import_no_repo_tools():
    """No module of the port and not ``chip_smoke.py`` imports a module of the
    repo's ``tools/`` (the JAX tools reach their siblings by putting ``tools/``
    on ``sys.path`` and importing them by name): no ``sys.path`` edit, no
    ``import tools``, no import of a ``tools/`` module by its bare name."""
    names = sorted(p.stem for p in (REPO / "tools").glob("*.py"))
    bare = re.compile(r"^\s*(import|from)\s+(tools|" + "|".join(names) + r")\b", re.M)
    sources = [REPO / "chip_smoke.py",
               *(REPO / "data_diet_distributed_tpu_torch").rglob("*.py")]
    offenders = []
    for path in sources:
        src = path.read_text()
        if bare.search(src) or re.search(r"sys\.path\.(insert|append)", src):
            offenders.append(str(path.relative_to(REPO)))
    assert offenders == []


def test_device_tools_refuse_without_a_card(tmp_path):
    """``python -m`` each tool that runs on a device, without ``--device cpu``,
    on this box without a card: a non-zero exit naming ``--device cpu``, and no
    output file (nothing ran on the CPU instead)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is then valid")
    env = {**os.environ, **SUBPROCESS_ENV,
           "PYTHONPATH": os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")])}
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"data_diet_distributed_tpu_torch.tools.{name}", *argv],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, argv in DEVICE_TOOLS.items()}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=120)
        assert proc.returncode != 0, (name, stdout, stderr)
        assert "--device cpu" in stderr, (name, stderr)
        assert "{" not in stdout, (name, stdout)
    assert sorted(os.listdir(tmp_path)) == []
