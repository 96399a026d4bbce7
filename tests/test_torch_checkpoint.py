"""PyTorch port: training checkpoints (``checkpoint.py``) and resume."""

import os

import numpy as np
import pytest
import torch

from data_diet_distributed_tpu_torch.checkpoint import CheckpointManager
from data_diet_distributed_tpu_torch.config import load_config
from data_diet_distributed_tpu_torch.models import create_model_from_cfg
from data_diet_distributed_tpu_torch.ops.scoring import score_dataset
from data_diet_distributed_tpu_torch.train import loop

BASE = ["data.dataset=synthetic", "data.synthetic_size=160", "data.batch_size=32",
        "data.eval_batch_size=64", "model.arch=tiny_cnn", "optim.lr=0.1",
        "train.half_precision=false", "score.pretrain_epochs=0",
        "optim.cosine_t_max_epochs=2", "data.augment=true"]


def cfg_with(*over):
    return load_config(None, [*BASE, *over])


def assert_states_equal(a, b):
    assert a.step == b.step
    for group in ("params", "batch_stats", "momentum"):
        ga, gb = getattr(a, group), getattr(b, group)
        assert set(ga) == set(gb)
        for k in ga:
            assert torch.equal(ga[k], gb[k]), (group, k)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One epoch of tiny_cnn with a checkpoint at its end."""
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "run")
    cfg = cfg_with("train.num_epochs=1")
    train_ds, test_ds = loop.load_data_for(cfg)
    return ckpt, loop.fit(cfg, train_ds, test_ds, device="cpu", checkpoint_dir=ckpt)


def test_save_restore_round_trip(trained):
    ckpt, res = trained
    mngr = CheckpointManager(ckpt)
    assert mngr.all_steps() == [5] and mngr.latest_step() == 5   # 160 / 32 steps
    assert_states_equal(mngr.restore(device="cpu"), res.state)
    meta = mngr.metrics(5)
    assert meta["epoch"] == 0 and meta["steps_per_epoch"] == 5
    assert meta["test_accuracy"] == res.history[0]["test_accuracy"]
    restored = mngr.restore(5, device="cpu")
    assert restored.params["Conv_0.weight"].is_contiguous(
        memory_format=torch.channels_last)


def test_resume_is_bitwise_equal_to_an_uninterrupted_fit(tmp_path):
    cfg = cfg_with("train.num_epochs=2")
    train_ds, test_ds = loop.load_data_for(cfg)
    whole = loop.fit(cfg, train_ds, test_ds, device="cpu")
    ckpt = str(tmp_path / "c")
    first = loop.fit(cfg, train_ds, test_ds, device="cpu", num_epochs=1,
                     checkpoint_dir=ckpt)
    assert first.state.step == 5
    resumed_cfg = cfg_with("train.num_epochs=2", "train.resume=true")
    rest = loop.fit(resumed_cfg, train_ds, test_ds, device="cpu", checkpoint_dir=ckpt)
    assert [h["epoch"] for h in rest.history] == [1]
    assert rest.history[0]["train_loss"] == whole.history[1]["train_loss"]
    assert_states_equal(rest.state, whole.state)
    assert CheckpointManager(ckpt).all_steps() == [5, 10]


def test_resume_with_another_batch_size_refuses_by_name(trained):
    ckpt, _ = trained
    cfg = cfg_with("train.num_epochs=2", "train.resume=true", "data.batch_size=16")
    train_ds, _ = loop.load_data_for(cfg)
    with pytest.raises(ValueError, match="steps_per_epoch=10 but the checkpoint was "
                                         "saved with 5"):
        loop.fit(cfg, train_ds, None, device="cpu", checkpoint_dir=ckpt)


def test_retention_keeps_the_newest(trained, tmp_path):
    _, res = trained
    mngr = CheckpointManager(str(tmp_path / "keep"), max_to_keep=2)
    for step in (3, 1, 7, 5):
        mngr.save(step, res.state, metrics={"epoch": step})
    assert mngr.all_steps() == [5, 7]
    assert sorted(os.listdir(mngr.directory)) == ["step_5", "step_7"]
    with pytest.raises(FileNotFoundError, match="no checkpoint at step 3"):
        mngr.restore(3, device="cpu")


def test_restore_variables_feeds_score_ckpt_step(trained, tmp_path):
    ckpt, res = trained
    cfg = cfg_with("score.method=el2n", "score.score_ckpt_step=5", "score.seeds=[0,1]",
                   f"train.checkpoint_dir={ckpt}")
    train_ds, _ = loop.load_data_for(cfg)
    variables = CheckpointManager(ckpt).restore_variables(5, device="cpu")
    assert set(variables) == set(res.state.variables)
    for k, v in variables.items():
        assert torch.equal(v, res.state.variables[k]), k
    scores, timings = loop.compute_scores(cfg, train_ds, device="cpu")
    assert timings["passes"] == 1   # one checkpoint, whatever score.seeds says
    want = score_dataset(create_model_from_cfg(cfg), [res.state.variables], train_ds,
                         method="el2n", batch_size=cfg.score.batch_size, device="cpu")
    assert np.array_equal(scores, want)


def test_corrupt_array_is_caught_by_its_digest(trained, tmp_path):
    _, res = trained
    mngr = CheckpointManager(str(tmp_path / "bad"))
    path = os.path.join(mngr.save(5, res.state, metrics={"epoch": 0}), "arrays.npz")
    with np.load(path) as f:
        arrays = {k: f[k] for k in f.files}
    arrays["params/classifier.bias"] = arrays["params/classifier.bias"] + 1e-3
    np.savez(path, **arrays)
    with pytest.raises(ValueError, match="'params/classifier.bias' fails its sha256"):
        mngr.restore(device="cpu")
    with pytest.raises(ValueError, match="sha256"):
        mngr.restore_variables(device="cpu")


def test_no_checkpoint_to_restore_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint to restore"):
        CheckpointManager(str(tmp_path / "empty")).restore(device="cpu")
