"""PyTorch port: ``ServeEngine`` request-vs-resident bit-identity and ranked answers."""

import numpy as np
import pytest
import torch

from data_diet_distributed_tpu_torch.config import load_config
from data_diet_distributed_tpu_torch.data.datasets import ArrayDataset, _synthetic
from data_diet_distributed_tpu_torch.models import create_model_from_cfg
from data_diet_distributed_tpu_torch.ops.scoring import score_dataset
from data_diet_distributed_tpu_torch.serve.engine import ServeEngine
from data_diet_distributed_tpu_torch.train.loop import score_variables_for_seeds
from data_diet_distributed_tpu_torch.weights import init_variables
from torch_threads import one_intra_op_thread  # noqa: F401


def _cfg(**over):
    items = {"data.dataset": "synthetic", "model.arch": "tiny_cnn",
             "train.half_precision": "false", "score.pretrain_epochs": "0",
             "score.batch_size": "16", "score.seeds": "[0,1]", **over}
    return load_config(None, [f"{k}={v}" for k, v in items.items()])


@pytest.fixture(scope="module")
def engine_and_ds():
    images, labels = _synthetic(37, 10, 2, "train")
    idx = (np.random.default_rng(1).permutation(37) * 3 + 7).astype(np.int32)
    ds = ArrayDataset(images, labels, idx, 10)
    engine = ServeEngine(_cfg(), device="cpu")
    engine.register_tenant("syn", ds)      # variables from the init-at-seed recipe
    return engine, ds


@pytest.mark.parametrize("method", ["el2n", "grand", "margin", "grand_last_layer"])
def test_score_batch_bitwise_equals_full_scores(engine_and_ds, method):
    engine, ds = engine_and_ds
    full = engine.full_scores("syn", method)
    assert full.dtype == np.float32 and full.shape == (37,)
    rng = np.random.default_rng(3)
    for n in (1, 5, 16):
        ids = rng.choice(ds.indices, size=n, replace=False)
        images, labels = engine.examples_for("syn", ids)
        got = engine.score_batch("syn", method, images, labels)
        want = full[engine.tenant("syn").pos_of(ids)]
        assert got.dtype == np.float32 and np.array_equal(got, want)


def test_full_scores_equal_score_dataset(engine_and_ds):
    engine, ds = engine_and_ds
    cfg = _cfg()
    variables = [init_variables("tiny_cnn", s, "cpu") for s in (0, 1)]
    offline = score_dataset(create_model_from_cfg(cfg), variables, ds, method="grand",
                            batch_size=16, device="cpu")
    assert np.array_equal(engine.full_scores("syn", "grand"), offline)


def test_topk_and_rank_break_ties_by_global_index():
    images, labels = _synthetic(12, 10, 0, "train")
    ds = ArrayDataset(images, labels, np.array([9, 3, 5, 1, 0, 2, 4, 6, 8, 7, 11, 10],
                                               np.int32), 10)
    engine = ServeEngine(_cfg(), device="cpu")
    engine.register_tenant("t", ds, [init_variables("tiny_cnn", 0, "cpu")])
    engine.tenant("t").scores["el2n"] = np.array(
        [1, 2, 2, 3, 1, 2, 3, 0, 0, 1, 2, 3], np.float32)   # planted ties
    assert list(engine.topk("t", "el2n", 4)) == [(1, 3.0), (4, 3.0), (10, 3.0),
                                                 (2, 2.0)]
    ids, scores = engine.rank("t", "el2n", [9, 5, 3, 2, 8])
    assert ids.tolist() == [2, 3, 5, 9, 8] and scores.tolist() == [2, 2, 2, 1, 0]
    with pytest.raises(KeyError):
        engine.examples_for("t", [99])
    with pytest.raises(ValueError, match="unservable"):
        engine.full_scores("t", "forgetting")


def test_pretrained_engine_scores_like_score_dataset():
    """``score.pretrain_epochs=1``: the engine pretrains one model per seed on
    the tenant's data; its resident scores equal ``score_dataset`` on the
    same pretrain, and its requests stay bitwise equal to them."""
    images, labels = _synthetic(40, 10, 3, "train")
    ds = ArrayDataset(images, labels, np.arange(40, dtype=np.int32), 10)
    cfg = _cfg(**{"score.pretrain_epochs": "1", "data.batch_size": "16"})
    engine = ServeEngine(cfg, device="cpu")
    engine.register_tenant("pre", ds)
    variables = score_variables_for_seeds(cfg, ds, device="cpu")
    init = init_variables("tiny_cnn", 0, "cpu")
    assert not torch.equal(variables[0]["classifier.weight"], init["classifier.weight"])
    for method in ("el2n", "grand"):
        offline = score_dataset(create_model_from_cfg(cfg), variables, ds, method=method,
                                batch_size=16, device="cpu")
        full = engine.full_scores("pre", method)
        assert np.array_equal(full, offline)
        got = engine.score_batch("pre", method, images[:5], labels[:5])
        assert np.array_equal(got, full[:5])


def test_engine_refuses_unported_recipes_and_missing_cuda():
    """``model.remat`` is a training-memory option: an engine built with it
    serves the scores of one built without it, bit for bit. Without CUDA the
    default device refuses."""
    rng = np.random.default_rng(5)
    ds = ArrayDataset(rng.normal(size=(12, 8, 8, 3)).astype(np.float32),
                      rng.integers(0, 10, 12).astype(np.int32),
                      np.arange(12, dtype=np.int32), 10)
    variables = [init_variables("resnet18", 0, "cpu")]
    served = {}
    for remat in ("false", "true"):
        engine = ServeEngine(_cfg(**{"model.arch": "resnet18", "model.remat": remat,
                                     "score.batch_size": "8"}), device="cpu")
        assert engine.model.remat == (remat == "true")
        engine.register_tenant("t", ds, variables)
        served[remat] = (engine.full_scores("t", "grand"),
                         engine.score_batch("t", "grand", *engine.examples_for("t", [3, 7])))
    for a, b in zip(served["false"], served["true"]):
        assert a.dtype == np.float32 and np.isfinite(a).all() and np.array_equal(a, b)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is then valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(_cfg())


def test_engine_units_fit_evaluate_score_and_checkpoint_refresh(tmp_path):
    """The composable units: ``fit``/``evaluate`` are ``train/loop``'s on the
    engine's device, ``score`` is ``full_scores``, ``serve.batch_size``
    overrides ``score.batch_size``, tenant weights feed the batcher, and
    ``load_checkpoint_variables`` restores the newest (or the named) step
    verified, then ``refresh_tenant`` serves it and clears the cached scores."""
    from data_diet_distributed_tpu_torch.checkpoint import CheckpointManager
    from data_diet_distributed_tpu_torch.train.loop import evaluate, fit

    images, labels = _synthetic(24, 10, 4, "train")
    ds = ArrayDataset(images, labels, np.arange(24, dtype=np.int32), 10)
    cfg = _cfg(**{"serve.batch_size": "8", "data.batch_size": "8",
                  "train.checkpoint_dir": str(tmp_path / "ckpt"), "train.num_epochs": "1"})
    engine = ServeEngine(cfg, device="cpu")
    assert engine.batch_size == 8
    res = engine.fit(ds, checkpoint_dir=cfg.train.checkpoint_dir)
    want = fit(cfg, ds, device="cpu")
    for k, v in want.state.params.items():
        assert torch.equal(res.state.params[k], v), k
    assert engine.evaluate(res.state, ds) == evaluate(engine.model, want.state, ds,
                                                      cfg.data.eval_batch_size, device="cpu")
    engine.register_tenant("t", ds, [init_variables("tiny_cnn", 0, "cpu")], weight=3)
    assert engine.tenant_weight("t") == 3 and engine.tenant_weight("nobody") == 1
    assert np.array_equal(engine.score("t", "el2n"), engine.full_scores("t", "el2n"))
    variables, step = engine.load_checkpoint_variables(cfg.train.checkpoint_dir)
    assert step == CheckpointManager(cfg.train.checkpoint_dir).latest_step()
    engine.refresh_tenant("t", [variables])
    assert engine.tenant("t").scores == {}
    offline = score_dataset(create_model_from_cfg(cfg), [variables], ds, method="grand",
                            batch_size=8, device="cpu")
    assert np.array_equal(engine.full_scores("t", "grand"), offline)
    with pytest.raises(FileNotFoundError):
        engine.load_checkpoint_variables(cfg.train.checkpoint_dir, step + 100)
    stats = engine.program_stats()
    assert set(stats) == {"tiny_cnn:(8, 32, 32, 3):el2n", "tiny_cnn:(8, 32, 32, 3):grand"}
    assert all(e["compiles"] == 1 and e["compile_s"] >= 0 for e in stats.values())
