"""PyTorch port, single process: the data-parallel layout, the rank rows, the
global augmentation draws, the ``mesh`` config and the consensus primitives,
against the JAX package's ``parallel/mesh.py``, ``data/pipeline.py``,
``config.py`` and ``resilience/consensus.py`` (``tests/test_consensus.py``'s
checks, here for both packages)."""

import dataclasses
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from data_diet_distributed_tpu import config as jax_config
from data_diet_distributed_tpu.data import datasets as flax_datasets
from data_diet_distributed_tpu.data.pipeline import BatchSharder
from data_diet_distributed_tpu.data.pipeline import iterate_batches as flax_iterate_batches
from data_diet_distributed_tpu.models import create_model as flax_create_model
from data_diet_distributed_tpu.parallel import mesh as jax_mesh
from data_diet_distributed_tpu.resilience import consensus as jax_consensus
from data_diet_distributed_tpu.resilience import inject as jax_inject
from data_diet_distributed_tpu_torch import config as port_config
from data_diet_distributed_tpu_torch.config import load_config
from data_diet_distributed_tpu_torch.data.augment import augment_batch
from data_diet_distributed_tpu_torch.data.datasets import ArrayDataset
from data_diet_distributed_tpu_torch.data.pipeline import (ResidentBatches, iterate_batches,
                                                           local_rows, prefetch_stream)
from data_diet_distributed_tpu_torch.parallel import mesh
from data_diet_distributed_tpu_torch.resilience import consensus, inject
from data_diet_distributed_tpu_torch.resilience.sentinel import DivergenceError, LossSentinel
from data_diet_distributed_tpu_torch.resilience.watchdog import Watchdog, WatchdogTimeout
from data_diet_distributed_tpu_torch.weights import init_variables


@pytest.fixture(autouse=True)
def _disarm_injectors():
    yield
    inject.deactivate()
    jax_inject.deactivate()


@pytest.mark.parametrize("shape", [(3, 3, 64, 128), (128, 64, 3, 3), (10,), (512, 10),
                                   (10, 512), (7, 3), (4,), (2,)])
@pytest.mark.parametrize("data_size", [2, 4, 8])
def test_zero1_rule_is_the_jax_rule(shape, data_size):
    want = jax_mesh._zero1_spec(P(), shape, data_size)
    d = mesh._zero1_spec(shape, data_size)
    assert (d is None) == (want == P())
    if d is not None:
        assert list(want)[d] == jax_mesh.DATA_AXIS


@pytest.mark.parametrize("arch", ["tiny_cnn", "resnet18"])
@pytest.mark.parametrize("data_size", [2, 8])
def test_sharded_fraction_on_the_port_layout_matches_jax(arch, data_size):
    """The port's OIHW leaves shard other dims than Flax's HWIO ones (a conv
    kernel's output channels where Flax's shards its input channels), but the
    same leaves, so the same share of the bytes."""
    params = {k: v for k, v in init_variables(arch, 0, "cpu").items()
              if not k.endswith(("running_mean", "running_var"))}
    fm = flax_create_model(arch, 10)
    shapes = jax.eval_shape(lambda k, x: fm.init(k, x, train=False), jax.random.key(0),
                            np.zeros((1, 32, 32, 3), np.float32))["params"]
    jmesh = jax_mesh.make_mesh(jax_config.MeshConfig(data_axis=data_size),
                               jax.devices()[:data_size])
    want = jax_mesh.UpdateSharding(jmesh).sharded_fraction(shapes)
    got = mesh.UpdateSharding(data_size, 0).sharded_fraction(params)
    assert got == pytest.approx(want, abs=1e-12) and got > 0.99


def test_update_sharding_slices_and_resolution(monkeypatch):
    sh = [mesh.UpdateSharding(2, r) for r in (0, 1)]
    t = torch.arange(4 * 3 * 3 * 3, dtype=torch.float32).reshape(4, 3, 3, 3)
    assert torch.equal(torch.cat([s.shard(t) for s in sh]), t)
    odd = torch.arange(3.0)
    assert sh[1].shard(odd) is odd
    m = port_config.MeshConfig()
    monkeypatch.setenv("DDT_SHARDED_UPDATE", "1")
    assert mesh.resolve_update_sharding(m, 1) is None     # disarmed at W = 1
    assert mesh.resolve_update_sharding(m, 2).data_size == 2
    assert mesh.resolve_slot_sharding(m, 2) is not None  # implies ZeRO-1
    monkeypatch.setenv("DDT_SHARDED_UPDATE", "0")
    assert mesh.resolve_update_sharding(m, 2) is None
    assert mesh.resolve_slot_sharding(m, 2) is None
    m.shard_opt_state = True
    assert mesh.resolve_slot_sharding(m, 2) is not None
    assert mesh.resolve_slot_sharding(m, 1) is None


@pytest.mark.parametrize("requested,world", [(60, 8), (64, 8), (15, 2), (7, 4), (128, 1)])
def test_global_batch_size_matches_batch_sharder(requested, world):
    jmesh = jax_mesh.make_mesh(jax_config.MeshConfig(data_axis=world), jax.devices()[:world])
    assert mesh.global_batch_size_for(requested, world) == \
        BatchSharder(jmesh).global_batch_size_for(requested)
    assert mesh.global_batch_size_for(60, 8) == 64


def _datasets(n=45):
    images, labels = flax_datasets._synthetic(n, 10, 2, "train")
    idx = (np.arange(n) * 3 + 5).astype(np.int32)
    return ArrayDataset(images, labels, idx, 10), flax_datasets.ArrayDataset(images, labels,
                                                                             idx, 10)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("shuffle", [False, True])
def test_rank_rows_equal_jax_rank_slices(world, shuffle):
    """``iterate_batches(image_slice=(r, W))`` bitwise JAX's (images local,
    the rest global); ``local_rows`` is the rank's ``np.array_split`` share
    (``BatchSharder``'s split); ``ResidentBatches`` and ``prefetch_stream``
    give the same rows."""
    ds, fds = _datasets()
    kw = {"shuffle": shuffle, "seed": 4, "epoch": 2}
    full = list(flax_iterate_batches(fds, 16, **kw))
    for r in range(world):
        want = list(flax_iterate_batches(fds, 16, image_slice=(r, world), **kw))
        got = list(iterate_batches(ds, 16, image_slice=(r, world), **kw))
        resident = list(ResidentBatches(ds, 16, "cpu", image_slice=(r, world))(**kw))
        streamed = list(prefetch_stream(ds, 16, "cpu", depth=0, image_slice=(r, world),
                                        **kw))
        assert len(want) == len(got) == len(resident) == len(streamed) == 3
        for w, g, f, res, st in zip(want, got, full, resident, streamed):
            for k in ("image", "label", "index", "mask"):
                assert np.array_equal(g[k], w[k]), k
                split = np.array_split(f[k], world)[r]
                assert np.array_equal(local_rows(g, (r, world))[k], split), k
                assert np.array_equal(res[k].numpy(), split), k
                assert np.array_equal(st[k].numpy(), split), k


def test_iterate_batches_refuses_an_indivisible_batch():
    ds, _ = _datasets()
    with pytest.raises(ValueError, match="global_batch_size_for"):
        next(iterate_batches(ds, 15, image_slice=(0, 2)))


@pytest.mark.parametrize("world", [2, 4])
def test_augmentation_rows_are_the_global_draws(world):
    """Each rank applies its rows of the global batch's draws: the ranks' outputs
    concatenated are the one-process augmentation, bitwise."""
    images = torch.from_numpy(np.random.default_rng(0).normal(
        size=(16, 8, 8, 3)).astype(np.float32))
    want = augment_batch(images, 3, 7, 4, True)
    b = 16 // world
    got = torch.cat([augment_batch(images[r * b:(r + 1) * b], 3, 7, 4, True,
                                   image_slice=(r, world)) for r in range(world)])
    assert torch.equal(got, want)


def test_mesh_config_matches_jax_and_takes_effect():
    want = {f.name: f.default for f in dataclasses.fields(jax_config.MeshConfig)}
    got = {f.name: f.default for f in dataclasses.fields(port_config.MeshConfig)}
    assert got == want
    cfg = load_config(None, ["mesh.multihost=true", "mesh.coordinator_address=h:1",
                             "mesh.num_processes=2", "mesh.process_id=1",
                             "mesh.shard_opt_state=true", "mesh.shard_weight_update=true",
                             "parallel.overlap.enabled=true"])
    assert (cfg.mesh.multihost, cfg.mesh.process_id, cfg.mesh.shard_opt_state) == (
        True, 1, True)
    with pytest.raises(ValueError, match="ROADMAP.md Queue 1 item 2"):
        load_config(None, ["mesh.model_axis=2"])
    for bad in (["mesh.multihost=true"],
                ["mesh.multihost=true", "mesh.coordinator_address=h:1",
                 "mesh.num_processes=2", "mesh.process_id=2"],
                ["mesh.multihost=true", "mesh.coordinator_address=h:1",
                 "mesh.num_processes=2", "mesh.process_id=0", "mesh.data_axis=4"]):
        with pytest.raises(ValueError, match="mesh"):
            load_config(None, bad)
    with pytest.raises(KeyError):
        load_config(None, ["mesh.bogus=1"])
    assert mesh.make_mesh(cfg.mesh, world=1) == mesh.Mesh(1, 1)
    with pytest.raises(ValueError, match="does not tile"):
        mesh.make_mesh(load_config(None, ["mesh.data_axis=3"]).mesh, world=1)
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        mesh.make_mesh(port_config.MeshConfig(model_axis=2), world=2)


def test_one_process_has_no_group():
    assert (mesh.world_size(), mesh.process_index(), mesh.is_primary()) == (1, 0, True)
    assert mesh.image_slice() is None
    mesh.sync_hosts("no-op")
    mesh.initialize_multihost(port_config.MeshConfig(), "cpu")   # multihost off: no-op
    assert mesh.world_size() == 1


@pytest.mark.parametrize("mod", [jax_consensus, consensus], ids=["jax", "torch"])
def test_agreement_primitives_single_process_identity(mod):
    assert mod.agree_any(True) is True and mod.agree_any(False) is False
    assert mod.agree_common([8, 4, 4]) == {4, 8} and mod.agree_common([]) == set()
    obj = {"stages": {"x": {"status": "done"}}}
    assert mod.broadcast_json(obj) == obj and mod.broadcast_json(None) is None
    assert mod.EXIT_RETRIABLE == 69 and mod.MAX_AGREE_ITEMS == 64


def test_consensus_create_is_none_in_one_process(tmp_path):
    cfg = load_config(None, [f"train.checkpoint_dir={tmp_path}/c"])
    assert consensus.Consensus.create(cfg) is None
    cfg.resilience.consensus = False
    assert consensus.Consensus.create(cfg) is None


@pytest.mark.parametrize("mod", [jax_consensus, consensus], ids=["jax", "torch"])
def test_consensus_direct_single_process(tmp_path, mod):
    c = mod.Consensus(str(tmp_path / "chan"), poll_every=4)
    assert c.agree(False) is False and c.agree(True) is True
    assert c.agree_restore_step([4, 8]) == 8 and c.agree_restore_step([]) is None
    assert c.agree_preempt(True, unit=3) is False
    assert c.agree_preempt(True, unit=4) is True
    assert c.agree_preempt(False, unit=5) is True   # latched


@pytest.mark.parametrize("mod", [jax_consensus, consensus], ids=["jax", "torch"])
def test_side_channel_poison_roundtrip(tmp_path, mod):
    d = str(tmp_path / "chan")
    r0, r1 = mod.SideChannel(d, 0), mod.SideChannel(d, 1)
    r0.open(), r1.open()
    assert r0.peer_poison() is None
    r1.poison("rank 1 watchdog: no heartbeat within 8s")
    info = r0.peer_poison()
    assert info["rank"] == 1 and "heartbeat" in info["reason"]
    assert r1.peer_poison() is None
    r1.open()
    assert r0.peer_poison() is None
    assert not [n for n in os.listdir(d) if n.endswith(".tmp")]
    c = mod.Consensus(d, poll_every=2)
    mod.SideChannel(d, 7).poison("injected")
    c.check_peers(1)                       # off-cadence: not polled
    with pytest.raises(mod.PeerPoisoned, match="rank 7"):
        c.check_peers(2)
    kw = mod.Consensus(str(tmp_path / "k"), grace_s=5.0).watchdog_kwargs()
    assert kw["escalate_s"] == 5.0 and kw["escalate_code"] == 69


def test_watchdog_poisons_on_fire_and_raises_a_peers_poison():
    fired = []
    with pytest.raises(WatchdogTimeout):
        with Watchdog(timeout_s=0.3, label="unit", on_fire=fired.append):
            time.sleep(30)
    assert fired and "no heartbeat" in fired[0]
    poison = consensus.PeerPoisoned("rank 1 poisoned the run")
    seen = threading.Event()
    t0 = time.monotonic()
    with pytest.raises(consensus.PeerPoisoned, match="rank 1"):
        with Watchdog(timeout_s=60.0, label="unit",
                      peer_check=lambda: poison if seen.is_set() else None) as wd:
            wd.beat()
            seen.set()
            time.sleep(30)
    assert time.monotonic() - t0 < 20.0


@pytest.mark.parametrize("agree,value,remote", [(lambda bad: True, 1.0, True),
                                                (lambda bad: bad, float("nan"), False)])
def test_sentinel_agreed_divergence(agree, value, remote):
    s = LossSentinel()
    s.check(1.0, epoch=0, tag="t", agree=lambda bad: False)
    with pytest.raises(DivergenceError) as err:
        s.check(value, epoch=3, tag="t", agree=agree)
    assert err.value.remote is remote and err.value.epoch == 3
    calls = []
    LossSentinel(enabled=False).check(float("nan"), epoch=0, tag="t",
                                      agree=lambda b: calls.append(b) or True)
    assert calls == []


@pytest.mark.parametrize("mod", [jax_inject, inject], ids=["jax", "torch"])
def test_rank_targeting_and_hidden_newest_step(mod):
    mod.activate(mod.FaultPlan(rank=1, step_exception_at=0))
    mod.fire("step", epoch=0, step=0)      # this process is rank 0
    mod.activate(mod.FaultPlan(rank=0, step_exception_at=0))
    with pytest.raises(RuntimeError, match="injected step exception"):
        mod.fire("step", epoch=0, step=0)
    mod.activate(mod.FaultPlan(hide_latest_durable=True))
    assert mod.transform("durable_candidates", [2, 4, 8]) == [2, 4]
    assert mod.transform("durable_candidates", [2, 4, 8]) == [2, 4, 8]   # once
    mod.activate(mod.FaultPlan(rank=1, hide_latest_durable=True))
    assert mod.transform("durable_candidates", [2, 4]) == [2, 4]
