"""PyTorch port: the sharded on-disk format (``ddt-shards-v1``), its bounded
shard cache and its hardened reads against the JAX package's.

The format is shared, so shards written by either package are read by the
other and compared bitwise. The storage fault classes (torn, EIO, slow reads)
arm in the port's ``FaultPlan`` and fire at its ``shard_read`` site.
"""

import os
import time

import numpy as np
import pytest

from data_diet_distributed_tpu.data import sharded as jax_sharded
from data_diet_distributed_tpu.data.datasets import load_dataset as jax_load_dataset
from data_diet_distributed_tpu.resilience import inject as jax_inject
from data_diet_distributed_tpu_torch.data import sharded
from data_diet_distributed_tpu_torch.data.datasets import load_dataset
from data_diet_distributed_tpu_torch.data.pipeline import iterate_batches
from data_diet_distributed_tpu_torch.resilience import inject

NORM = (np.array([0.4, 0.5, 0.6], np.float32), np.array([0.2, 0.25, 0.3], np.float32))


@pytest.fixture(autouse=True)
def _disarm():
    yield
    for mod in (inject, jax_inject):
        mod.deactivate()
    for mod in (sharded, jax_sharded):
        mod.drain_fault_records()


def make_split(seed: int = 0, n: int = 100):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, 8, 8, 3), dtype=np.uint8),
            rng.integers(0, 5, n).astype(np.int32))


def write(mod, path, shard_size: int = 32):
    """Train (100 rows, 4 shards) and test (40 rows) with ``mod``'s writer."""
    (tr_x, tr_y), (te_x, te_y) = make_split(0), make_split(1, 40)
    splits = {"train": mod.write_split(str(path), "train", tr_x, tr_y, shard_size),
              "test": mod.write_split(str(path), "test", te_x, te_y, shard_size)}
    mod.write_manifest(str(path), splits, 5, NORM)
    return tr_x, te_x


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_shards_cross_read_bitwise(tmp_path, writer, reader):
    w = {"jax": jax_sharded, "port": sharded}[writer]
    load = {"jax": jax_load_dataset, "port": load_dataset}[reader]
    tr_x, te_x = write(w, tmp_path)
    assert (sharded.read_manifest(str(tmp_path))
            == jax_sharded.read_manifest(str(tmp_path)))
    train, test = load("sharded", str(tmp_path))
    for ds, want in ((train, tr_x), (test, te_x)):
        assert ds.num_classes == 5 and ds.norm is not None
        np.testing.assert_array_equal(np.asarray(ds.images), want)
        rows = np.array([31, 32, 0, len(want) - 1])   # across shard boundaries
        np.testing.assert_array_equal(ds.images[rows], want[rows])


def test_sharded_batches_bitwise_jax_and_npy(tmp_path):
    """The sharded plane gathers through the cache, then normalizes with the
    same kernel as the npy plane: the port's batches equal the JAX
    package's, and the port's npy-mmap batches, bitwise."""
    from data_diet_distributed_tpu.data.pipeline import iterate_batches as jax_batches
    tr_x, _ = write(sharded, tmp_path / "s")
    train, _ = load_dataset("sharded", str(tmp_path / "s"), host_cache_bytes=2 * 32 * 192)
    jtrain, _ = jax_load_dataset("sharded", str(tmp_path / "s"))
    os.makedirs(tmp_path / "n")
    for split, x in (("train", tr_x), ("test", make_split(1, 40)[0])):
        np.save(tmp_path / "n" / f"{split}_images.npy", x)
        np.save(tmp_path / "n" / f"{split}_labels.npy", np.zeros(len(x), np.int32))
    np.savez(tmp_path / "n" / "stats.npz", mean=NORM[0], std=NORM[1])
    npy, _ = load_dataset("npz", str(tmp_path / "n"))
    kw = dict(shuffle=True, seed=1, epoch=0)
    for a, b, c in zip(iterate_batches(train, 24, **kw), jax_batches(jtrain, 24, **kw),
                       iterate_batches(npy, 24, **kw)):
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["image"], c["image"])
        np.testing.assert_array_equal(a["label"], b["label"])
    assert train.images.cache.evictions > 0
    assert train.images.cache.bytes_in_use <= train.images.cache.budget_bytes


def test_verify_manifest_names_the_same_torn_files(tmp_path):
    write(sharded, tmp_path)
    assert sharded.verify_manifest(str(tmp_path)) == []
    with open(tmp_path / "train-shard-00001.npy", "r+b") as fh:
        fh.seek(200)
        fh.write(b"\xff\xff")
    os.remove(tmp_path / "test-shard-00001.npy")
    got = sharded.verify_manifest(str(tmp_path))
    assert got == jax_sharded.verify_manifest(str(tmp_path))
    assert len(got) == 2 and "train-shard-00001.npy digest mismatch" in got[0]
    assert sharded.is_sharded_dir(str(tmp_path)) and not sharded.is_sharded_dir(str(tmp_path / "x"))
    assert sharded.owned_shards(5, 1, 2) == jax_sharded.owned_shards(5, 1, 2) == [1, 3]


def test_shard_cache_evicts_as_jax(tmp_path):
    seq = [0, 1, 0, 2, 3, 1, 1, 0, 3, 2, 0]
    stats = []
    for mod in (sharded, jax_sharded):
        cache = mod.ShardCache(budget_bytes=2500)
        for k in seq:
            cache.get(k, lambda k=k: np.zeros(1000 + 100 * k, np.uint8))
        stats.append(cache.stats())
    assert stats[0] == stats[1] and stats[0]["evictions"] > 0
    with pytest.raises(ValueError, match="positive"):
        sharded.ShardCache(0)


def test_eio_recovers_in_place_with_one_record(tmp_path):
    tr_x, _ = write(sharded, tmp_path)
    inject.activate(inject.plan_from_dict({"eio_shard_read": 2}))
    train, _ = load_dataset("sharded", str(tmp_path), read_backoff_s=0.0)
    np.testing.assert_array_equal(np.asarray(train.images), tr_x)
    recs = sharded.drain_fault_records()
    assert len(recs) == 1
    rec = recs[0]
    assert (rec["kind"], rec["split"], rec["shard"], rec["recovered"], rec["retries"],
            rec["error_class"]) == ("data_fault", "train", 2, True, 1, "transient_io")
    assert train.images.retries_used == 1 and not train.images.quarantined


def test_torn_shard_quarantines_and_serves_no_rows(tmp_path):
    write(sharded, tmp_path)
    inject.activate(inject.plan_from_dict({"torn_shard_read": 1}))
    train, _ = load_dataset("sharded", str(tmp_path), read_retries=2, read_backoff_s=0.0)
    with pytest.raises(sharded.ShardReadError) as ei:
        train.images[np.arange(40)]
    err = ei.value
    assert (err.split, err.shard, err.error_class, err.retries) == (
        "train", 1, "digest_mismatch", 2)
    kinds = [(r["kind"], r.get("recovered")) for r in sharded.drain_fault_records()]
    assert kinds == [("data_fault", False), ("shard_quarantine", None)]
    inject.deactivate()   # the bytes on disk were never torn: quarantine holds anyway
    with pytest.raises(sharded.ShardReadError, match="quarantined"):
        train.images[np.array([33])]
    np.testing.assert_array_equal(train.images[np.array([0])], make_split(0)[0][:1])


def test_skip_quarantined_serves_zeros_and_reports_rows(tmp_path):
    tr_x, _ = write(sharded, tmp_path)
    inject.activate(inject.plan_from_dict({"torn_shard_read": 3}))
    train, _ = load_dataset("sharded", str(tmp_path), read_retries=1, read_backoff_s=0.0,
                            skip_quarantined=True)
    got = np.asarray(train.images)
    np.testing.assert_array_equal(got[:96], tr_x[:96])
    assert not got[96:].any()
    np.testing.assert_array_equal(train.images.quarantined_rows(), np.arange(96, 100))


def test_storage_classes_arm_and_fire_at_the_shard_read_site():
    """The JAX package's storage classes under its field names: the port's
    plan takes them, and its ``shard_read`` site fires each as JAX's does."""
    for mod in (inject, jax_inject):
        mod.activate(mod.plan_from_dict({"eio_shard_read": 0, "eio_on_read": 2})
                     if mod is inject else mod.FaultPlan(eio_shard_read=0, eio_on_read=2))
        mod.fire("shard_read", shard=0, split="train", read=1)   # not yet
        with pytest.raises(OSError, match="injected EIO on read 2 of shard 0"):
            mod.fire("shard_read", shard=0, split="train", read=2)
        mod.fire("shard_read", shard=0, split="train", read=3)   # fired once
        mod.deactivate()
    torn = []
    for mod in (inject, jax_inject):
        mod.activate(mod.FaultPlan(torn_shard_read=1))
        torn.append(mod.transform("shard_read", bytes(range(64)), shard=1, split="train",
                                  read=1))
    assert torn[0] == torn[1] != bytes(range(64))
    assert inject.transform("shard_read", b"abc", shard=0, split="train", read=1) == b"abc"
    inject.activate(inject.plan_from_dict({"slow_shard_read_ms": 30.0}))
    t0 = time.perf_counter()
    inject.fire("shard_read", shard=5, split="test", read=1)
    assert time.perf_counter() - t0 >= 0.03
