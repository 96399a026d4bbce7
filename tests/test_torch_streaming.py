"""PyTorch port: the streaming data plane (``PrefetchIterator``,
``prefetch_stream``, ``ScoreStream``, a streamed ``fit``) against its resident
twin and against the JAX package (``tests/test_streaming.py``'s pins).

Streamed and resident scores and fits are compared bitwise; lazy data against
the JAX package's ``score_dataset`` at the scoring tests' tolerances (EL2N
rtol 1e-5 / atol 1e-6, GraNd rtol 2e-4 / atol 1e-6).
"""

import json
import time

import jax
import numpy as np
import pytest
import torch

from data_diet_distributed_tpu.data.datasets import load_dataset as jax_load_dataset
from data_diet_distributed_tpu.data.pipeline import PrefetchIterator as JaxPrefetchIterator
from data_diet_distributed_tpu.models import create_model as flax_create_model
from data_diet_distributed_tpu.ops.scoring import score_dataset as flax_score_dataset
from data_diet_distributed_tpu_torch.config import load_config
from data_diet_distributed_tpu_torch.data import sharded
from data_diet_distributed_tpu_torch.data.datasets import load_dataset
from data_diet_distributed_tpu_torch.data.pipeline import (PrefetchIterator, iterate_batches,
                                                           merge_stall_stats, prefetch_stream)
from data_diet_distributed_tpu_torch.models import create_model
from data_diet_distributed_tpu_torch.ops.scoring import score_dataset
from data_diet_distributed_tpu_torch.resilience import inject
from data_diet_distributed_tpu_torch.train import loop
from data_diet_distributed_tpu_torch.utils.io import read_prune_manifest
from data_diet_distributed_tpu_torch.weights import params_from_flax
from test_torch_data import to_npy, write_npz
from test_torch_models import randomize_bn
from test_torch_sharded import write as write_shards


@pytest.fixture(autouse=True)
def _disarm():
    yield
    inject.deactivate()
    sharded.drain_fault_records()


def test_prefetch_iterator_order_stats_and_close():
    items = list(range(24))
    for depth in (2, 0):
        it = PrefetchIterator(iter(items), depth=depth, stage="unit")
        assert list(it) == items
        assert (it._thread is None) == (depth == 0)
        st = it.stats()
        assert set(st) == set(JaxPrefetchIterator(iter([]), depth=0).stats())
        assert st["prefetch_depth"] == depth and st["items"] == 24 and st["stall_s"] >= 0

    def endless():
        i = 0
        while True:
            yield i
            i += 1

    it = PrefetchIterator(endless(), depth=2, stage="unit")
    assert next(it) == 0
    t0 = time.monotonic()
    it.close()
    it.close()
    assert time.monotonic() - t0 < 5.0
    it._thread.join(timeout=5.0)
    assert not it._thread.is_alive()

    total = {}
    for stall in (1.0, 3.0):
        merge_stall_stats(total, {"stage": "train", "prefetch_depth": 2, "items": 4,
                                  "stall_s": stall, "warmup_s": 0.5, "elapsed_s": 10.0,
                                  "stall_frac": stall / 10})
    assert (total["items"], total["stall_s"], total["elapsed_s"], total["stall_frac"]) == (
        8, 4.0, 20.0, 0.2)


def test_prefetch_reraises_shard_error_with_coordinates(tmp_path):
    write_shards(sharded, tmp_path)
    inject.activate(inject.FaultPlan(torn_shard_read=1))
    train, _ = load_dataset("sharded", str(tmp_path), read_retries=0, read_backoff_s=0.0)
    it = prefetch_stream(train, 24, "cpu", depth=2, stage="train")
    with pytest.raises(sharded.ShardReadError) as ei:
        list(it)
    coords = ei.value.data_plane_coords
    assert (coords["stage"], coords["batch_index"], coords["split"], coords["shard"],
            coords["error_class"]) == ("train", 1, "train", 1, "digest_mismatch")
    assert "[prefetch:train]" in "".join(ei.value.__notes__)
    it._thread.join(timeout=5.0)
    assert not it._thread.is_alive()


def test_prefetch_close_interrupts_wedged_retry_backoff(tmp_path):
    write_shards(sharded, tmp_path)
    inject.activate(inject.FaultPlan(torn_shard_read=0))
    train, _ = load_dataset("sharded", str(tmp_path), read_retries=50, read_backoff_s=0.5)
    it = prefetch_stream(train, 16, "cpu", depth=2, stage="train")
    time.sleep(0.3)   # the assembler reaches the retry loop
    t0 = time.monotonic()
    it.close()
    assert time.monotonic() - t0 < 5.0 and not it._thread.is_alive()
    assert not sharded._READ_INTERRUPT.is_set()   # later readers are not poisoned


@pytest.mark.parametrize("depth", [0, 2])
def test_prefetch_stream_is_iterate_batches(tmp_path, depth):
    write_shards(sharded, tmp_path)
    train, _ = load_dataset("sharded", str(tmp_path))
    kw = dict(shuffle=True, seed=3, epoch=2)
    got = list(prefetch_stream(train, 24, "cpu", depth=depth, **kw))
    want = list(iterate_batches(train, 24, **kw))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert torch.equal(g[k], torch.from_numpy(w[k])), k


def tiny_seeds(num_classes: int, size: int, seeds=(0, 1)):
    """(flax model, Flax variables, port variables) of BN-randomized tiny_cnns."""
    fm = flax_create_model("tiny_cnn", num_classes)
    out = []
    for s in seeds:
        tree = randomize_bn(fm.init(jax.random.key(s), np.zeros((1, size, size, 3),
                                                                np.float32), train=False),
                            np.random.default_rng(s))
        out.append((tree, params_from_flax(tree, create_model("tiny_cnn", num_classes))))
    return fm, out


@pytest.mark.parametrize("method,rtol", [("el2n", 1e-5), ("grand", 2e-4)])
def test_streaming_scores_equal_resident_and_jax_on_lazy_data(tmp_path, method, rtol):
    write_npz(tmp_path, "u8", n_train=70)
    to_npy(tmp_path, stats=False)
    lazy, _ = load_dataset("npz", str(tmp_path))
    fm, seeds = tiny_seeds(lazy.num_classes, 12)
    model = create_model("tiny_cnn", lazy.num_classes)
    dense = lazy.dense()
    runs = {}
    for name, ds, plane in (("stream", dense, "streaming"), ("resident", dense, "resident"),
                            ("lazy", lazy, "streaming")):
        partials, log = [], []
        runs[name] = score_dataset(
            model, [v for _, v in seeds], ds, method=method, batch_size=16, device="cpu",
            data_plane=plane, prefetch_depth=2, on_seed_done=lambda k, s: partials.append(s),
            log=lambda kind, **f: log.append((kind, f)))
        runs[name + "_partials"], runs[name + "_log"] = partials, log
    assert np.array_equal(runs["stream"], runs["resident"])
    for a, b in zip(runs["stream_partials"], runs["resident_partials"]):
        assert a.dtype == np.float64 and np.array_equal(a, b)
    assert runs["resident_log"] == []
    (kind, rec), = runs["stream_log"]
    assert kind == "data_plane" and rec["engine"] == "stream" and rec["fault"] is None
    assert rec["items"] == 2 * 5 and rec["prefetch_depth"] == 2
    flax_lazy, _ = jax_load_dataset("npz", str(tmp_path))
    want = flax_score_dataset(fm, [t for t, _ in seeds], flax_lazy, method=method,
                              batch_size=16, device_resident=False)
    np.testing.assert_allclose(runs["lazy"], want, rtol=rtol, atol=1e-6)


FIT = ["data.dataset=synthetic", "data.synthetic_size=150", "data.batch_size=32",
       "data.eval_batch_size=40", "model.arch=tiny_cnn", "train.half_precision=false",
       "train.num_epochs=2", "train.log_every_steps=1000", "data.augment=true"]


def test_streaming_fit_bitwise_resident_and_depth_inert():
    logs = {}
    runs = {}
    for name, over in (("resident", ["data.data_plane=resident"]),
                       ("stream2", ["data.data_plane=streaming", "data.prefetch_depth=2"]),
                       ("stream0", ["data.data_plane=streaming", "data.prefetch_depth=0"])):
        cfg = load_config(None, [*FIT, *over])
        train_ds, test_ds = loop.load_data_for(cfg)
        logs[name] = []
        runs[name] = loop.fit(cfg, train_ds, test_ds, device="cpu",
                              log=lambda kind, _l=logs[name], **f: _l.append((kind, f)))
    for name in ("stream2", "stream0"):
        assert ([h["train_loss"] for h in runs[name].history]
                == [h["train_loss"] for h in runs["resident"].history])
        assert ([h["test_accuracy"] for h in runs[name].history]
                == [h["test_accuracy"] for h in runs["resident"].history])
        for k, v in runs["resident"].state.variables.items():
            assert torch.equal(v, runs[name].state.variables[k]), (name, k)
    for name, engine, depth in (("resident", "resident", 0), ("stream2", "stream", 2),
                                ("stream0", "stream", 0)):
        planes = [f for kind, f in logs[name] if kind == "data_plane"]
        assert len(planes) == 1 and planes[0]["engine"] == engine
        assert planes[0]["prefetch_depth"] == depth and planes[0]["fault"] is None
    assert [f for k, f in logs["stream2"] if k == "data_plane"][0]["items"] == 2 * 5


def test_run_on_sharded_data_skips_a_quarantined_shard(tmp_path):
    """A ``run`` on streamed sharded data with a torn shard under
    ``skip_quarantined``: it finishes, the quarantined rows leave the kept set
    and the prune manifest lists them; each fit and the score pass log one
    ``data_plane`` record, after the fault records."""
    write_shards(sharded, tmp_path / "d")
    inject.activate(inject.FaultPlan(torn_shard_read=2))
    cfg = load_config(None, [
        "data.dataset=sharded", f"data.data_dir={tmp_path / 'd'}", "data.batch_size=32",
        "data.eval_batch_size=40", "data.data_plane=streaming", "data.read_retries=1",
        "data.read_backoff_s=0", "data.skip_quarantined=true",
        f"data.host_cache_bytes={2 * 32 * 192}", "model.arch=tiny_cnn",
        "train.half_precision=false", "train.num_epochs=1", "score.method=el2n",
        "score.pretrain_epochs=1", "score.seeds=[0]", "score.batch_size=32",
        "prune.sparsity=0.5", f"train.checkpoint_dir={tmp_path / 'ckpt'}"])
    log = []
    out = loop.run_datadiet(cfg, device="cpu", log=lambda kind, **f: log.append((kind, f)))
    npz = loop.scores_npz_path(str(tmp_path / "ckpt"))
    manifest = read_prune_manifest(npz)
    assert manifest["quarantined_shards"] == [2] and manifest["quarantined_rows"] == 32
    dropped = manifest["quarantined_dropped_from_kept"]
    assert dropped > 0 and out["n_kept"] == manifest["n_kept"] == 50 - dropped
    with np.load(npz) as f:
        assert not np.isin(f["kept"], np.arange(64, 96)).any()   # shard 2's rows
    kinds = [k for k, _ in log]
    assert kinds.count("shard_quarantine") == 1
    assert kinds.index("shard_quarantine") < kinds.index("data_plane")
    planes = [f for k, f in log if k == "data_plane"]
    assert [p["stage"] for p in planes] == ["score_pretrain_seed0", "score", "final"]
    assert all(0 < p["host_cache_bytes_in_use"] <= p["host_cache_budget_bytes"]
               for p in planes[:2])
    assert "host_cache_budget_bytes" not in planes[2]   # the kept rows sit in RAM
    assert planes[0]["quarantined_shards"] == [2]
    json.dumps(log)   # every record is JSON
