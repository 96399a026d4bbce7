"""PyTorch port: the npz, npy-mmap and synthetic_imagenet datasets and the host
batch assembler against the JAX package's, on the same files.

Every comparison here is bitwise (``assert_array_equal``): both sides are
numpy, and the port's native library is the repo's ``native/datadiet_native.cpp``
built by the port's own loader. The one last-bits fact (the lazy gather
multiplies by ``1/std``, ``dense()`` divides) is pinned as such.
"""

import os
from pathlib import Path

import numpy as np
import pytest

from data_diet_distributed_tpu.data import native as jax_native
from data_diet_distributed_tpu.data.datasets import load_dataset as jax_load_dataset
from data_diet_distributed_tpu.data.pipeline import iterate_batches as jax_iterate_batches
from data_diet_distributed_tpu_torch.config import load_config
from data_diet_distributed_tpu_torch.data import native
from data_diet_distributed_tpu_torch.data.datasets import load_dataset
from data_diet_distributed_tpu_torch.data.pipeline import iterate_batches
from data_diet_distributed_tpu_torch.data.sharded import write_manifest, write_split
from data_diet_distributed_tpu_torch.train.loop import load_data_for

REPO = Path(__file__).resolve().parent.parent
MEAN = np.array([0.45, 0.5, 0.55], np.float32)
STD = np.array([0.2, 0.25, 0.3], np.float32)


def write_npz(path, kind: str, n_train: int = 70, n_test: int = 30, seed: int = 0):
    """train.npz/test.npz of 12x12 images: ``u8`` (derived stats), ``u8_stats``
    (explicit), ``f32`` (no stats) or ``f32_stats``; class 6 only in test."""
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("test", n_test)):
        labels = rng.integers(0, 6 if split == "train" else 7, n).astype(np.int32)
        if kind.startswith("u8"):
            images = rng.integers(0, 256, (n, 12, 12, 3), dtype=np.uint8)
        else:
            images = rng.normal(0.3, 2.0, (n, 12, 12, 3)).astype(np.float32)
        extra = {"mean": MEAN, "std": STD} if kind.endswith("stats") and split == "train" else {}
        np.savez(os.path.join(path, f"{split}.npz"), images=images, labels=labels, **extra)


def to_npy(path, stats: bool):
    """The npz splits as ``{split}_images.npy``/``_labels.npy`` (+ stats.npz)."""
    for split in ("train", "test"):
        with np.load(os.path.join(path, f"{split}.npz")) as f:
            np.save(os.path.join(path, f"{split}_images.npy"), f["images"])
            np.save(os.path.join(path, f"{split}_labels.npy"), f["labels"])
    if stats:
        np.savez(os.path.join(path, "stats.npz"), mean=MEAN, std=STD)


def assert_same(got, want):
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.num_classes == w.num_classes
        np.testing.assert_array_equal(g.labels, w.labels)
        np.testing.assert_array_equal(g.indices, w.indices)
        assert np.asarray(g.images).dtype == np.asarray(w.images).dtype
        np.testing.assert_array_equal(np.asarray(g.images), np.asarray(w.images))
        assert (g.norm is None) == (w.norm is None)
        if g.norm is not None:
            for a, b in zip(g.norm, w.norm):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["u8", "u8_stats", "f32", "f32_stats"])
def test_npz_loads_like_jax(tmp_path, kind):
    write_npz(tmp_path, kind)
    got = load_dataset("npz", str(tmp_path))
    assert_same(got, jax_load_dataset("npz", str(tmp_path)))
    assert got[0].norm is None and got[0].images.dtype == np.float32
    assert got[0].num_classes == 7   # the test split's class counts


@pytest.mark.parametrize("kind,stats", [("u8", False), ("u8", True), ("f32", True)])
def test_npy_mmap_loads_like_jax(tmp_path, kind, stats):
    write_npz(tmp_path, kind)
    to_npy(tmp_path, stats)
    got = load_dataset("npz", str(tmp_path))
    assert_same(got, jax_load_dataset("npz", str(tmp_path)))
    assert isinstance(got[0].images, np.memmap) and got[0].norm is not None
    # dense() divides as the JAX package's does: bitwise.
    for g, w in zip(got, jax_load_dataset("npz", str(tmp_path))):
        np.testing.assert_array_equal(g.dense().images, w.dense().images)
        sub = g.subset(g.indices[::3])
        assert sub.norm is not None and len(sub) == len(g.indices[::3])
        np.testing.assert_array_equal(sub.dense().images,
                                      g.dense().subset(g.indices[::3]).images)


def test_mixed_dtypes_and_stale_npy_refused_as_in_jax(tmp_path):
    write_npz(tmp_path, "u8")
    with np.load(tmp_path / "test.npz") as f:
        labels = f["labels"]
    np.savez(tmp_path / "test.npz", images=np.zeros((4, 12, 12, 3), np.float32),
             labels=labels[:4])
    for load in (load_dataset, jax_load_dataset):
        with pytest.raises(ValueError, match="mixed image dtypes"):
            load("npz", str(tmp_path))
    write_npz(tmp_path, "u8")
    to_npy(tmp_path, stats=False)
    later = os.path.getmtime(tmp_path / "train_images.npy") + 10
    os.utime(tmp_path / "train.npz", (later, later))
    for load in (load_dataset, jax_load_dataset):
        with pytest.raises(ValueError, match="newer than its converted"):
            load("npz", str(tmp_path))


def test_synthetic_imagenet_is_bit_identical():
    got = load_dataset("synthetic_imagenet", synthetic_size=24, seed=3)
    want = jax_load_dataset("synthetic_imagenet", synthetic_size=24, seed=3)
    assert_same(got, want)
    assert got[0].images.shape == (24, 96, 96, 3) and len(got[1]) == 100
    assert got[0].num_classes == 100


def lazy_sets():
    """(name, eager f32, lazy uint8, lazy float32) datasets of 45 rows."""
    rng = np.random.default_rng(4)
    u8 = rng.integers(0, 256, (45, 6, 6, 3), dtype=np.uint8)
    f32 = rng.normal(size=(45, 6, 6, 3)).astype(np.float32)
    labels = rng.integers(0, 5, 45).astype(np.int32)
    out = {}
    for name, images, norm in (("eager", f32, None), ("lazy_u8", u8, (MEAN, STD)),
                               ("lazy_f32", f32, (MEAN, STD))):
        out[name] = images, labels, np.arange(45, dtype=np.int32)[::-1].copy(), norm
    return out


@pytest.mark.parametrize("name", ["eager", "lazy_u8", "lazy_f32"])
@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
def test_batch_assembler_is_bitwise_jax_native(monkeypatch, name, use_native):
    images, labels, indices, norm = lazy_sets()[name]
    assert jax_native.load() is not None   # JAX's native gather is the reference
    if use_native:
        assert native.load() is not None and os.path.exists(native.LIB_PATH)
    else:
        monkeypatch.setattr(native, "load", lambda: None)
    take = np.array([7, 3, 44, 0, 19], np.int64)    # 5 rows into 8: a padded tail
    got = native.BatchAssembler().assemble(images, labels, indices, take, 8, norm=norm)
    want = jax_native.BatchAssembler().assemble(images, labels, indices, take, 8, norm=norm)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[3], [1, 1, 1, 1, 1, 0, 0, 0])


def test_lazy_gather_and_dense_differ_in_the_last_bits():
    """The JAX package's own two paths: its native gather multiplies by 1/255
    and 1/std, its ``dense()`` (and its NumPy fallback) divide. The port
    reproduces each bitwise (above); between them the values differ by a few
    ulps, within the JAX package's own lazy-against-dense tolerance (atol 1e-6,
    ``tests/test_data.py``)."""
    images, labels, indices, norm = lazy_sets()["lazy_u8"]
    gather = native.normalize_u8_numpy(images, np.arange(45, dtype=np.int64), *norm, 45)
    dense = ((images.astype(np.float32) / 255.0) - norm[0]) / norm[1]
    np.testing.assert_allclose(gather, dense, rtol=0, atol=1e-6)
    assert (gather != dense).any()   # they do differ: equality would be luck


@pytest.mark.parametrize("shuffle", [False, True])
def test_iterate_batches_on_lazy_data_is_bitwise_jax(tmp_path, shuffle):
    write_npz(tmp_path, "u8", n_train=50)
    to_npy(tmp_path, stats=False)
    ds, _ = load_dataset("npz", str(tmp_path))
    fds, _ = jax_load_dataset("npz", str(tmp_path))
    kw = dict(shuffle=shuffle, seed=2, epoch=1)
    got, want = list(iterate_batches(ds, 16, **kw)), list(jax_iterate_batches(fds, 16, **kw))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for k in ("image", "label", "index", "mask"):
            np.testing.assert_array_equal(g[k], w[k])


def test_baseline_config5_sharded_dry_run(tmp_path):
    """BASELINE config 5 pointed at a sharded directory (``tests/test_data.py``'s
    dry run): the yaml loads with ``data.dataset=sharded``, ``load_data_for``
    syncs the class count, and a batch assembles within the cache budget."""
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (128, 16, 16, 3), dtype=np.uint8)
    labels = rng.integers(0, 7, 128).astype(np.int32)
    splits = {"train": write_split(str(tmp_path), "train", imgs, labels, 32),
              "test": write_split(str(tmp_path), "test", imgs[:32], labels[:32], 32)}
    write_manifest(str(tmp_path), splits, 7,
                   (np.full(3, 0.5, np.float32), np.full(3, 0.25, np.float32)))
    cfg = load_config(str(REPO / "configs" / "imagenet_resnet50_grand.yaml"), [
        "data.dataset=sharded", f"data.data_dir={tmp_path}", "data.batch_size=32",
        "data.eval_batch_size=32", "data.data_plane=streaming",
        f"data.host_cache_bytes={64 << 10}", f"train.checkpoint_dir={tmp_path}/ckpt"])
    assert cfg.model.arch == "resnet50" and cfg.score.method == "grand"
    assert cfg.train.half_precision is True and cfg.model.stem == "imagenet"
    train, test = load_data_for(cfg)
    assert cfg.model.num_classes == train.num_classes == 7
    batch = next(iterate_batches(train, cfg.data.batch_size))
    assert batch["image"].shape == (32, 16, 16, 3) and batch["image"].dtype == np.float32
    cache = train.images.cache
    assert cache.loads > 0 and cache.bytes_in_use <= cache.budget_bytes
