"""PyTorch port: the ``score`` command and import hygiene (no JAX, no JAX package)."""

import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from data_diet_distributed_tpu_torch import cli

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


@pytest.mark.parametrize("argv,match", [
    (["score", "--config", SMOKE, "--device", "cpu"], "pretrain_epochs=1"),
    (["score", "--config", SMOKE, "--device", "cpu", "score.pretrain_epochs=0",
      "score.score_ckpt_step=3"], "score_ckpt_step"),
    (["train", "--config", SMOKE], "training slice"),
    (["run", "--config", SMOKE], "training slice"),
])
def test_cli_refuses_what_needs_training(argv, match):
    with pytest.raises(NotImplementedError, match=match):
        cli.main(argv)


def test_cli_without_cuda_raises(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is then valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["score", "--config", SMOKE, "score.pretrain_epochs=0",
                  f"train.checkpoint_dir={tmp_path}/c"])


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
    """Every module imports and a CPU score runs while JAX, Flax, optax, the
    oracle and the JAX package are unimportable."""
    script = textwrap.dedent("""
        import pkgutil, sys
        for name in ("jax", "jaxlib", "flax", "optax", "oracle",
                     "data_diet_distributed_tpu"):
            sys.modules[name] = None
        import numpy as np
        import data_diet_distributed_tpu_torch as port
        for mod in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
            __import__(mod.name)
        from data_diet_distributed_tpu_torch.data.datasets import load_dataset
        from data_diet_distributed_tpu_torch.models import create_model
        from data_diet_distributed_tpu_torch.ops.scoring import score_dataset
        from data_diet_distributed_tpu_torch.weights import init_variables
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
