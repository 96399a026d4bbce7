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
    with pytest.raises(NotImplementedError, match="remat"):
        ServeEngine(_cfg(**{"model.remat": "true"}), device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is then valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(_cfg())
