"""PyTorch port: the commands (``score``, ``train``, ``run``, ``sweep``) end to end on
the CPU, and import hygiene (no JAX, no JAX package)."""

import json
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from data_diet_distributed_tpu_torch import cli
from data_diet_distributed_tpu_torch.checkpoint import CheckpointManager
from data_diet_distributed_tpu_torch.pruning import verify_prune_manifest
from data_diet_distributed_tpu_torch.train import loop
from torch_threads import SUBPROCESS_ENV, one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "data_diet_distributed_tpu_torch")
SMOKE = os.path.join(REPO, "configs", "synthetic_smoke.yaml")


def test_cli_score_writes_npz(tmp_path, capsys):
    ckpt = tmp_path / "ckpt"
    rc = cli.main(["score", "--config", SMOKE, "--device", "cpu",
                   "score.pretrain_epochs=0", "data.synthetic_size=40",
                   "score.batch_size=16", f"train.checkpoint_dir={ckpt}"])
    assert rc == 0
    with np.load(f"{ckpt}_scores.npz") as f:
        assert f["scores"].shape == (40,) and f["scores"].dtype == np.float32
        assert np.isfinite(f["scores"]).all() and (f["scores"] > 0).all()
        assert np.array_equal(f["indices"], np.arange(40))
        assert str(f["method"]) == "grand"
    assert '"event": "scores_saved"' in capsys.readouterr().out


#: Tiny sizes for the end-to-end commands on configs/synthetic_smoke.yaml.
TINY = ["data.synthetic_size=96", "data.batch_size=32", "score.batch_size=32",
        "score.grand_chunk=8"]


def _summary(capsys) -> dict:
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


def test_cli_serve_subprocess_scores_bitwise_and_exits_75(tmp_path):
    """``cli serve --device cpu`` boots on port 0 (announced on stderr), scores
    a request bitwise the in-process engine on the same init variables, and a
    SIGTERM drains it to exit 75 with ``[preempted]``; without CUDA and without
    ``--device cpu`` the command raises."""
    import signal
    import time
    import urllib.request

    from data_diet_distributed_tpu_torch.config import load_config
    from data_diet_distributed_tpu_torch.serve.engine import ServeEngine

    over = ["data.dataset=synthetic", "data.synthetic_size=40", "model.arch=tiny_cnn",
            "train.half_precision=false", "score.pretrain_epochs=0", "score.batch_size=16",
            "score.seeds=[0,1]", "serve.port=0", "serve.methods=[el2n,grand]",
            f"obs.metrics_path={tmp_path}/m.jsonl", f"train.checkpoint_dir={tmp_path}/c"]
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "DDT_FAULT_PLAN")}
    env.update(PYTHONPATH=REPO, **SUBPROCESS_ENV)   # this process's one thread
    proc = subprocess.Popen([sys.executable, "-m", "data_diet_distributed_tpu_torch.cli",
                             "serve", "--config", SMOKE, "--device", "cpu", *over],
                            cwd=tmp_path, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port, deadline = None, time.monotonic() + 120
        while port is None and time.monotonic() < deadline:
            line = proc.stderr.readline()
            assert line or proc.poll() is None, proc.returncode
            if line.startswith("{") and json.loads(line).get("kind") == "obs_server":
                port = json.loads(line)["port"]
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/score",
            data=json.dumps({"indices": [3, 17, 39], "method": "grand"}).encode())
        with urllib.request.urlopen(req, timeout=60) as resp:
            served = np.asarray(json.load(resp)["scores"], np.float32)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    assert proc.returncode == 75 and "[preempted]" in out, (proc.returncode, out)
    engine = ServeEngine(load_config(SMOKE, over), device="cpu")
    engine.register_tenant("synthetic", loop.load_data_for(engine.cfg)[0])
    assert np.array_equal(served, engine.full_scores("synthetic", "grand")[[3, 17, 39]])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["serve", "--config", SMOKE, *over])


# The trajectory scores and model.remat, refused before they were ported, run.
@pytest.mark.parametrize("argv,event", [
    (["score", "score.method=forgetting", "score.pretrain_epochs=2"], "scores_saved"),
    (["train", "model.arch=resnet18", "model.remat=true", "data.synthetic_size=16",
      "data.batch_size=16", "train.num_epochs=1"], "train_done"),
    (["run", "score.method=aum", "train.num_epochs=1"], "run_done"),
])
def test_cli_runs_what_needed_training(tmp_path, capsys, argv, event):
    command, *over = argv
    assert cli.main([command, "--config", SMOKE, "--device", "cpu", *TINY,
                     f"train.checkpoint_dir={tmp_path / 'ckpt'}", *over]) == 0
    out = _summary(capsys)
    assert out["event"] == event
    if command == "score":
        assert out["n_scores"] == 96 and np.isfinite(out["mean"])
    elif command == "train":
        assert out["epochs"] == 1 and 0.0 <= out["final_test_accuracy"] <= 1.0
    else:
        assert out["score_method"] == "aum" and out["n_kept"] == 48


def test_cli_train_fits_and_checkpoints(tmp_path, capsys):
    ckpt = tmp_path / "dense"
    assert cli.main(["train", "--config", SMOKE, "--device", "cpu", *TINY,
                     "train.num_epochs=2", "train.checkpoint_every=1",
                     f"train.checkpoint_dir={ckpt}"]) == 0
    out = _summary(capsys)
    assert out["event"] == "train_done" and out["epochs"] == 2
    assert out["epoch_s"]["count"] == 1 and out["examples_per_s"] > 0
    assert 0.0 <= out["final_test_accuracy"] <= 1.0
    assert CheckpointManager(str(ckpt)).all_steps() == [3, 6]


def test_cli_run_pretrains_scores_prunes_and_retrains(tmp_path, capsys):
    ckpt = tmp_path / "run"
    assert cli.main(["run", "--config", SMOKE, *TINY, "train.num_epochs=1",
                     f"train.checkpoint_dir={ckpt}", "--device", "cpu"]) == 0
    out = _summary(capsys)
    assert out["event"] == "run_done" and out["n_kept"] == 48 and out["n_train"] == 96
    for stage in ("pretrain_wall_s", "score_wall_s", "prune_wall_s", "train_wall_s"):
        assert out[stage] > 0, stage
    assert np.isfinite(out["final_test_accuracy"])
    npz = f"{ckpt}_scores.npz"
    with np.load(npz) as f:
        kept, method = f["kept"], str(f["method"])
        assert f["scores"].shape == (96,) and np.isfinite(f["scores"]).all()
    assert method == "grand" and len(kept) == 48
    manifest = verify_prune_manifest(npz, kept)
    assert manifest["n_kept"] == 48 and manifest["method"] == "grand"
    assert out["prune_manifest"] == f"{npz}.provenance.json"
    with pytest.raises(ValueError, match="prune-provenance mismatch"):
        verify_prune_manifest(npz, kept[1:])
    assert CheckpointManager(str(ckpt)).latest_step() == 2   # 48 kept / 32


def test_cli_sweep_scores_once_for_two_levels(tmp_path, capsys, monkeypatch):
    calls = []
    real = loop.score_dataset

    def counted(*args, **kwargs):
        calls.append(kwargs["method"])
        return real(*args, **kwargs)
    monkeypatch.setattr(loop, "score_dataset", counted)
    ckpt = tmp_path / "sweep"
    assert cli.main(["sweep", "--config", SMOKE, "--device", "cpu", *TINY,
                     "train.num_epochs=1", "score.method=el2n", "score.seeds=[0]",
                     "prune.sweep=[0.25,0.5]", f"train.checkpoint_dir={ckpt}"]) == 0
    out = _summary(capsys)
    assert calls == ["el2n"]
    assert [lvl["n_kept"] for lvl in out["levels"]] == [72, 48]
    assert all(lvl["scoring_shared"] for lvl in out["levels"])
    for level, kept in (("s0p25", 72), ("s0p5", 48)):
        with np.load(f"{ckpt}_{level}_scores.npz") as f:
            assert len(f["kept"]) == kept


def test_cli_score_after_a_pretrain(tmp_path, capsys):
    ckpt = tmp_path / "s"
    assert cli.main(["score", "--config", SMOKE, "--device", "cpu", *TINY,
                     "score.pretrain_epochs=1", "score.method=el2n",
                     f"train.checkpoint_dir={ckpt}"]) == 0
    out = _summary(capsys)
    assert out["event"] == "scores_saved" and out["pretrain_s"] > 0
    with np.load(f"{ckpt}_scores.npz") as f:
        scores = f["scores"]
    assert scores.shape == (96,) and np.isfinite(scores).all()
    # A pretrained model scores differently from the init.
    assert cli.main(["score", "--config", SMOKE, "--device", "cpu", *TINY,
                     "score.pretrain_epochs=0", "score.method=el2n",
                     f"train.checkpoint_dir={tmp_path}/init"]) == 0
    with np.load(f"{tmp_path}/init_scores.npz") as f:
        assert not np.allclose(f["scores"], scores)


def test_cli_score_reuses_scores_npz(tmp_path, capsys):
    first = tmp_path / "a"
    assert cli.main(["score", "--config", SMOKE, "--device", "cpu", *TINY,
                     "score.pretrain_epochs=0", f"train.checkpoint_dir={first}"]) == 0
    assert cli.main(["score", "--config", SMOKE, "--device", "cpu", *TINY,
                     f"score.scores_npz={first}_scores.npz",
                     f"train.checkpoint_dir={tmp_path}/b"]) == 0
    with np.load(f"{first}_scores.npz") as a, np.load(f"{tmp_path}/b_scores.npz") as b:
        assert np.array_equal(a["scores"], b["scores"])
        assert str(b["method"]) == f"reused:{first}_scores.npz"
    with pytest.raises(ValueError, match="holds 'grand' scores"):
        cli.main(["score", "--config", SMOKE, "--device", "cpu", *TINY,
                  "score.method=el2n", f"score.scores_npz={first}_scores.npz",
                  f"train.checkpoint_dir={tmp_path}/c"])


def test_cli_run_preempted_exits_75_then_resumes(tmp_path):
    """A drill through the real command line: a fault plan in DDT_FAULT_PLAN
    preempts ``run`` after the first seed's scores (exit 75, ``[preempted]``);
    the same command without it re-enters at the scoring stage and finishes."""
    ckpt = tmp_path / "run"
    cmd = [sys.executable, "-m", "data_diet_distributed_tpu_torch.cli", "run",
           "--config", SMOKE, *TINY, "train.num_epochs=1",
           f"train.checkpoint_dir={ckpt}", "--device", "cpu"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    drill = subprocess.run(cmd, env={**env, "DDT_FAULT_PLAN":
                                     '{"sigterm_after_seed_scores": 1}'},
                           cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert drill.returncode == 75, drill.stderr[-3000:]
    assert drill.stdout.startswith("[preempted] preempted by SIGTERM")
    assert os.listdir(f"{ckpt}_score_partials") == ["seed0.npz"]
    rerun = subprocess.run(cmd, env=env, cwd=tmp_path, capture_output=True, text=True,
                           timeout=300)
    assert rerun.returncode == 0, rerun.stderr[-3000:]
    out = json.loads(rerun.stdout.strip().splitlines()[-1])
    assert out["event"] == "run_done" and out["n_kept"] == 48
    events = [json.loads(line) for line in rerun.stderr.splitlines()
              if line.startswith("{")]
    resumed = [e for e in events if e["kind"] == "score_seeds_resumed"]
    assert [(e["done"], e["todo"]) for e in resumed] == [([0], [1])]


def test_cli_refuses_an_unported_fault_class(tmp_path, monkeypatch):
    """Every JAX fault class is ported now: a class neither package has
    refuses by name before any work."""
    monkeypatch.setenv("DDT_FAULT_PLAN", '{"kill_host_after_epoch": 0}')
    with pytest.raises(ValueError, match="kill_host_after_epoch"):
        cli.main(["train", "--config", SMOKE, "--device", "cpu", *TINY,
                  f"train.checkpoint_dir={tmp_path}/c"])


@pytest.mark.parametrize("device,rc", [(None, 69), ("cpu", 0)])
def test_cli_init_probe_failure_exits_69(tmp_path, capsys, monkeypatch, device, rc):
    """``resilience.init_probe=true``: a CUDA device whose bounded init probe
    fails ends the command with exit 69 before any work; ``--device cpu`` does
    not probe."""
    from data_diet_distributed_tpu_torch.resilience import watchdog
    monkeypatch.setattr(watchdog, "PROBE_SNIPPET", 'raise SystemExit("no CUDA device")')
    ckpt = tmp_path / "ckpt"
    argv = ["score", "--config", SMOKE, "score.pretrain_epochs=0",
            "data.synthetic_size=40", "score.batch_size=16",
            "resilience.init_probe=true", "resilience.probe_attempts=1",
            "resilience.probe_backoff_s=0", f"train.checkpoint_dir={ckpt}"]
    assert cli.main(argv + (["--device", device] if device else [])) == rc
    err = capsys.readouterr().err
    assert ("device init failed after 1 attempts: no CUDA device" in err) == (rc == 69)
    assert os.path.exists(f"{ckpt}_scores.npz") == (rc == 0)


def test_cli_without_cuda_raises(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is then valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["score", "--config", SMOKE, "score.pretrain_epochs=0",
                  f"train.checkpoint_dir={tmp_path}/c"])


@pytest.mark.parametrize("command", ["train", "run", "sweep"])
def test_cli_training_commands_without_cuda_raise(tmp_path, command):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is then valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([command, "--config", SMOKE, f"train.checkpoint_dir={tmp_path}/c"])
    assert not os.path.exists(f"{tmp_path}/c")


def _port_sources():
    for root, _, files in os.walk(PORT):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(root, name)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_sources_import_no_jax():
    banned = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|oracle|"
                        r"data_diet_distributed_tpu)\b(?!_torch)", re.M)
    offenders = []
    for path in _port_sources():
        with open(path) as fh:
            if banned.search(fh.read()):
                offenders.append(os.path.relpath(path, REPO))
    assert offenders == []


def test_port_runs_with_jax_blocked(tmp_path):
    """Every module imports (an example, a script of notebook cells, runs as
    ``-m`` runs it, on the CPU) and a CPU score runs while JAX, Flax, optax,
    the oracle and the JAX package are unimportable."""
    script = textwrap.dedent("""
        import pkgutil, runpy, sys
        for name in ("jax", "jaxlib", "flax", "optax", "oracle",
                     "data_diet_distributed_tpu"):
            sys.modules[name] = None
        import numpy as np
        import data_diet_distributed_tpu_torch as port
        examples = port.__name__ + ".examples."
        for mod in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
            if mod.name.startswith(examples):
                sys.argv = [mod.name, "--device", "cpu", "--size", "64"]
                runpy.run_module(mod.name, run_name="__main__")
            else:
                __import__(mod.name)
        from data_diet_distributed_tpu_torch.data.datasets import load_dataset
        from data_diet_distributed_tpu_torch.models import create_model
        from data_diet_distributed_tpu_torch.ops.scoring import score_dataset
        from data_diet_distributed_tpu_torch.weights import init_variables
        from data_diet_distributed_tpu_torch import cli
        cli.main(["run", "data.dataset=synthetic", "data.synthetic_size=16",
                  "model.arch=tiny_cnn", "data.batch_size=8", "score.batch_size=8",
                  "score.pretrain_epochs=1", "train.num_epochs=1",
                  "train.half_precision=false", "train.checkpoint_dir=ck",
                  "--device", "cpu"])
        ds, _ = load_dataset("synthetic", synthetic_size=8)
        v = [init_variables("tiny_cnn", 0, "cpu")]
        for method in ("el2n", "grand"):
            s = score_dataset(create_model("tiny_cnn", 10), v, ds, method=method,
                              batch_size=8, device="cpu")
            assert s.shape == (8,) and np.isfinite(s).all()
        assert not any(m == "jax" or m.startswith(("jax.", "flax", "optax"))
                       for m in sys.modules if sys.modules[m] is not None)
        print("OK")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("OK")
