"""PyTorch port: data, config, ``score_dataset`` and pruning against the JAX package."""

import os
import pickle

import jax
import numpy as np
import pytest

from data_diet_distributed_tpu import pruning as flax_pruning
from data_diet_distributed_tpu.config import load_config as flax_load_config
from data_diet_distributed_tpu.data import datasets as flax_datasets
from data_diet_distributed_tpu.data.pipeline import \
    iterate_batches as flax_iterate_batches
from data_diet_distributed_tpu.models import create_model as flax_create_model
from data_diet_distributed_tpu.ops.scoring import score_dataset as flax_score_dataset
from data_diet_distributed_tpu_torch import pruning
from data_diet_distributed_tpu_torch.config import load_config
from data_diet_distributed_tpu_torch.data import datasets
from data_diet_distributed_tpu_torch.data.pipeline import iterate_batches, num_batches
from data_diet_distributed_tpu_torch.models import create_model
from data_diet_distributed_tpu_torch.ops.scoring import score_dataset
from data_diet_distributed_tpu_torch.weights import params_from_flax
from test_torch_models import randomize_bn
from torch_threads import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("clusters", [1, 3])
def test_synthetic_is_bit_identical(clusters):
    for split in ("train", "test"):
        got = datasets._synthetic(64, 10, 5, split, noise=0.7, clusters=clusters)
        want = flax_datasets._synthetic(64, 10, 5, split, noise=0.7,
                                        clusters=clusters)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_cifar_pickles_load_like_jax(tmp_path):
    root = tmp_path / "cifar-10-batches-py"
    root.mkdir()
    rng = np.random.default_rng(0)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(root / name, "wb") as fh:
            pickle.dump({b"data": rng.integers(0, 256, (3, 3072), dtype=np.uint8),
                         b"labels": list(rng.integers(0, 10, 3))}, fh)
    got = datasets.load_dataset("cifar10", str(tmp_path))
    want = flax_datasets.load_dataset("cifar10", str(tmp_path))
    for g, w in zip(got, want):
        assert np.array_equal(g.images, w.images)
        assert np.array_equal(g.labels, w.labels)
        assert np.array_equal(g.indices, w.indices) and g.num_classes == 10


def test_tail_batch_rule_matches_jax():
    images, labels = datasets._synthetic(21, 10, 0, "train")
    idx = np.arange(100, 121, dtype=np.int32)[::-1].copy()
    ds = datasets.ArrayDataset(images, labels, idx, 10)
    fds = flax_datasets.ArrayDataset(images, labels, idx, 10)
    got = list(iterate_batches(ds, 8))
    want = list(flax_iterate_batches(fds, 8, shuffle=False))
    assert len(got) == len(want) == num_batches(21, 8) == 3
    for g, w in zip(got, want):
        for key in ("image", "label", "index", "mask"):
            assert np.array_equal(g[key], w[key]), key
    assert np.array_equal(got[-1]["image"][5:], np.broadcast_to(images[0], (3, 32, 32, 3)))


@pytest.mark.parametrize("name", sorted(os.listdir(os.path.join(REPO, "configs"))))
def test_repo_configs_load(name):
    path = os.path.join(REPO, "configs", name)
    got, want = load_config(path), flax_load_config(path)
    for section in ("data", "model", "score", "prune", "train", "checkpoint", "elastic",
                    "tuning"):
        assert vars(getattr(got, section)) == vars(getattr(want, section)), section


def test_config_overrides_and_unknown_keys():
    cfg = load_config(None, ["score.seeds=[0,1]", "train.half_precision=false",
                             "optim.lr=0.5", "serve.methods=[el2n]",
                             "parallel.overlap.enabled=true"])
    assert cfg.score.seeds == (0, 1) and cfg.train.half_precision is False
    for bad in ("data.bogus=1", "optim.bogus=1", "bogus.x=1", "obs.metrics_path.x=1"):
        with pytest.raises(KeyError):
            load_config(None, [bad])
    with pytest.raises(ValueError):
        load_config(None, ["prune.sparsity=1.5"])


def _tiny_seed_variables(seed):
    fm = flax_create_model("tiny_cnn", 10)
    tree = randomize_bn(fm.init(jax.random.key(seed), np.zeros((1, 32, 32, 3),
                                                               np.float32),
                                train=False), np.random.default_rng(seed))
    return fm, tree, params_from_flax(tree, create_model("tiny_cnn", 10))


def test_score_dataset_matches_jax_and_prunes_alike():
    """2 seeds, N not a multiple of B, shuffled global indices."""
    n, b = 45, 16
    images, labels = datasets._synthetic(n, 10, 3, "train")
    idx = (np.random.default_rng(0).permutation(n) + 1000).astype(np.int32)
    ds = datasets.ArrayDataset(images, labels, idx, 10)
    fds = flax_datasets.ArrayDataset(images, labels, idx, 10)
    seeds = [_tiny_seed_variables(s) for s in (0, 1)]
    fm = seeds[0][0]
    model = create_model("tiny_cnn", 10)
    for method, rtol in (("el2n", 1e-5), ("grand", 2e-4)):
        want = flax_score_dataset(fm, [t for _, t, _ in seeds], fds, method=method,
                                  batch_size=b)
        done = []
        got = score_dataset(model, [v for _, _, v in seeds], ds, method=method,
                            batch_size=b, device="cpu",
                            on_seed_done=lambda k, s: done.append((k, s.dtype)))
        assert got.dtype == np.float32 and got.shape == (n,)
        assert done == [(0, np.float64), (1, np.float64)]
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6)
        streamed = score_dataset(model, [v for _, _, v in seeds], ds, method=method,
                                 batch_size=b, device="cpu", device_resident=False)
        assert np.array_equal(streamed, got)
        for sparsity, keep in ((0.5, "hardest"), (0.3, "easiest")):
            assert np.array_equal(
                pruning.select_indices(got, idx, sparsity, keep=keep),
                flax_pruning.select_indices(got, idx, sparsity, keep=keep))


@pytest.mark.parametrize("keep,class_balance", [
    ("hardest", False), ("easiest", False), ("random", False), ("hardest", True)])
def test_select_indices_matches_jax_with_ties(keep, class_balance):
    rng = np.random.default_rng(4)
    scores = rng.integers(0, 5, 60).astype(np.float32)   # many ties
    idx = rng.permutation(200)[:60].astype(np.int32)
    labels = rng.integers(0, 3, 60)
    got = pruning.select_indices(scores, idx, 0.4, keep=keep, seed=2, labels=labels,
                                 class_balance=class_balance)
    want = flax_pruning.select_indices(scores, idx, 0.4, keep=keep, seed=2,
                                       labels=labels, class_balance=class_balance)
    assert np.array_equal(got, want) and len(got) == pruning.num_kept(60, 0.4)


def test_score_dataset_needs_a_device_or_cuda():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is then valid")
    images, labels = datasets._synthetic(4, 10, 0, "train")
    ds = datasets.ArrayDataset(images, labels, np.arange(4, dtype=np.int32), 10)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        score_dataset(create_model("tiny_cnn", 10), [], ds)
