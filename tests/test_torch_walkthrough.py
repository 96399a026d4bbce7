"""PyTorch port: the scoring walkthrough
(``data_diet_distributed_tpu_torch.examples.walkthrough``), against the JAX
package's ``examples/walkthrough.py``.

* The walkthrough's cells (its ``# %%`` markers) are the JAX walkthrough's.
* Run in process on the CPU at 256 examples with its pretrain fit replaced by
  a JAX init carried across with ``weights.params_from_flax``, its EL2N and
  GraNd cells score within EL2N rtol 1e-5 and GraNd rtol 2e-4 (atol 1e-6) of
  the JAX package's ``score_dataset`` on the same weights and data; the
  later cells (prune, retrain, forgetting, AUM) run for real on those scores.
* ``python -m ... --device cpu`` runs every cell end to end; without a card
  the default ``--device cuda`` exits non-zero before it trains.

On the card it runs in ``chip_smoke.py``'s walkthrough phase.
"""

from __future__ import annotations

import os
import runpy
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from data_diet_distributed_tpu.config import load_config as flax_load_config
from data_diet_distributed_tpu.data.datasets import load_dataset as flax_load_dataset
from data_diet_distributed_tpu.models import create_model_from_cfg as flax_create_model
from data_diet_distributed_tpu.ops import scoring as flax_scoring
from data_diet_distributed_tpu_torch.models import create_model_from_cfg
from data_diet_distributed_tpu_torch.train import loop
from data_diet_distributed_tpu_torch.train.state import state_from_variables
from data_diet_distributed_tpu_torch.weights import params_from_flax
from test_torch_models import numpy_tree
from torch_threads import SUBPROCESS_ENV, one_intra_op_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
MODULE = "data_diet_distributed_tpu_torch.examples.walkthrough"
PORT_FILE = REPO / "data_diet_distributed_tpu_torch" / "examples" / "walkthrough.py"
JAX_FILE = REPO / "examples" / "walkthrough.py"
N = 256

#: Each cell's printed line, in order.
PRINTS = ["device=", "pretrain: ", "EL2N: ", "GraNd: ", "spearman(EL2N, GraNd) = ",
          "kept ", "retrain on 50%: ", "forgetting: ", "aum: "]


def _cells(path: Path) -> list[str]:
    return [line for line in path.read_text().splitlines() if line.startswith("# %%")]


def test_the_cells_are_the_jax_walkthroughs():
    port, jax_cells = _cells(PORT_FILE), _cells(JAX_FILE)
    assert len(port) == len(jax_cells) == 11
    # The same steps in the same order; the setup and scoring cells name the
    # device where the JAX ones name the mesh, and the last names the port's CLI.
    same = [0, 2, 5, 6, 7, 8, 9]
    assert [port[i] for i in same] == [jax_cells[i] for i in same]


@pytest.fixture(scope="module")
def carried(monkeypatch_module):
    """The walkthrough's globals from one in-process run at N examples whose
    pretrain returned a JAX init (seed 0) carried across, and the JAX
    package's data, model and init."""
    jcfg = flax_load_config(None, ["data.dataset=synthetic", f"data.synthetic_size={N}",
                                   "model.arch=tiny_cnn", "train.half_precision=false"])
    jds, _ = flax_load_dataset("synthetic", synthetic_size=N, seed=jcfg.train.seed)
    jcfg.model.num_classes = jds.num_classes
    fm = flax_create_model(jcfg)
    tree = fm.init(jax.random.key(0), np.zeros((1, *jds.images.shape[1:]), np.float32),
                   train=False)
    real_fit = loop.fit

    def fit(cfg, train_ds, test_ds=None, **kw):
        if kw.get("tag", "train") != "train":
            return real_fit(cfg, train_ds, test_ds, **kw)
        state = state_from_variables(params_from_flax(numpy_tree(tree)),
                                     create_model_from_cfg(cfg))
        return loop.FitResult(state=state, history=[{"epoch": 0, "carried": "jax init"}])

    monkeypatch_module.setattr(loop, "fit", fit)
    monkeypatch_module.setattr(sys, "argv", ["walkthrough", "--device", "cpu",
                                             "--size", str(N)])
    return runpy.run_module(MODULE, run_name="__main__"), (jds, fm, tree)


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.mark.parametrize("name,method,rtol", [("el2n", "el2n", 1e-5),
                                              ("grand", "grand", 2e-4)])
def test_scores_match_jax_on_carried_weights(carried, name, method, rtol):
    g, (jds, fm, tree) = carried
    np.testing.assert_array_equal(g["train_ds"].images, jds.images)
    np.testing.assert_array_equal(g["train_ds"].labels, jds.labels)
    want = flax_scoring.score_dataset(fm, [tree], jds, method=method, batch_size=256)
    np.testing.assert_allclose(g[name], want, rtol=rtol, atol=1e-6)


def test_later_cells_run_on_the_carried_scores(carried):
    g, _ = carried
    assert g["result"].history == [{"epoch": 0, "carried": "jax init"}]
    assert len(g["subset"]) == N // 2
    # The kept half is the hardest half by the walkthrough's GraNd.
    kept_scores = g["grand"][np.isin(g["train_ds"].indices, g["kept"])]
    assert kept_scores.min() >= np.median(g["grand"])
    assert 0.0 <= g["retrain"].final_test_accuracy <= 1.0
    for name in ("forget", "aum"):
        assert g[name].shape == (N,) and np.isfinite(g[name]).all(), name
    # At most pretrain_epochs - 1 events, or the never-learned sentinel.
    events = g["forget"]
    assert ((events <= 1) | (events > g["cfg_f"].score.pretrain_epochs)).all()


def test_end_to_end_on_the_cpu(tmp_path):
    env = {**os.environ, **SUBPROCESS_ENV,
           "PYTHONPATH": os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run([sys.executable, "-m", MODULE, "--device", "cpu", "--size", str(N)],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(tuple(PRINTS))]
    assert [next(p for p in PRINTS if ln.startswith(p)) for ln in lines] == PRINTS
    assert lines[0] == f"device=cpu  train={N} examples"
    assert lines[5] == f"kept {N // 2}/{N} hardest examples"
    assert sorted(os.listdir(tmp_path)) == []


def test_without_a_card_exits_nonzero(monkeypatch):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is then valid")
    monkeypatch.setattr(sys, "argv", ["walkthrough", "--size", "64"])
    with pytest.raises(SystemExit) as exc:
        runpy.run_module(MODULE, run_name="__main__")
    assert exc.value.code not in (0, None) and "--device cpu" in str(exc.value.code)
