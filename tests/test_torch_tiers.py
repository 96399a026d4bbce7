"""PyTorch port: the local checkpoint tier (``checkpoint.py::LocalTier``), the
cases of ``tests/test_checkpoint_tiers.py``.

The fits are tiny_cnn on 256 synthetic examples, batch 64 (4 steps an epoch,
checkpoints every epoch), the JAX tests' coordinates, on the CPU. The tier's
layout is the JAX package's (``<dir>_tiered/step_<N>/promoted.rank<k>.json``
and ``<dir>_local``), so the JAX package's ``tier_steps`` and
``local_tier_dir`` read the port's directories and must give the port's
answers. The ZeRO-1 case saves the two ranks' parts of a W = 2 state in one
process (explicit rank and world, no process group) and restores it at
W = 1 and W = 2 bitwise.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from data_diet_distributed_tpu import checkpoint as jax_checkpoint
from data_diet_distributed_tpu_torch.checkpoint import (CheckpointManager, LocalTier,
                                                        local_tier_dir,
                                                        restore_tier_payload, tier_map,
                                                        tier_steps, tiered_dir)
from data_diet_distributed_tpu_torch.config import load_config
from data_diet_distributed_tpu_torch.obs.metrics import MetricsLogger
from data_diet_distributed_tpu_torch.parallel.mesh import UpdateSharding
from data_diet_distributed_tpu_torch.resilience import inject
from data_diet_distributed_tpu_torch.resilience.integrity import CheckpointCorrupt
from data_diet_distributed_tpu_torch.resilience.preemption import Preempted
from data_diet_distributed_tpu_torch.train import loop
from data_diet_distributed_tpu_torch.train.state import TrainState, shard_slots
from torch_threads import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _disarm():
    yield
    inject.deactivate()


@pytest.fixture(scope="module")
def tiny_data():
    cfg = _cfg("/unused")
    return loop.load_data_for(cfg)[0]


def _cfg(tmp_path, **over):
    overrides = [
        "data.dataset=synthetic", "data.synthetic_size=256", "data.batch_size=64",
        "model.arch=tiny_cnn", "optim.lr=0.1", "train.num_epochs=2",
        "train.half_precision=false", "train.checkpoint_every=1",
        "train.log_every_steps=1000", f"train.checkpoint_dir={tmp_path}/ckpt",
        "checkpoint.local_tier=true", f"obs.metrics_path={tmp_path}/metrics.jsonl",
        "score.pretrain_epochs=0",
    ] + [f"{k}={v}" for k, v in over.items()]
    return load_config(None, overrides)


def _fit(cfg, train_ds, log=None):
    return loop.fit(cfg, train_ds, None, device="cpu", log=log,
                    checkpoint_dir=cfg.train.checkpoint_dir)


def _states_equal(a: TrainState, b: TrainState) -> bool:
    return a.step == b.step and all(
        torch.equal(getattr(a, g)[k].cpu(), getattr(b, g)[k].cpu())
        for g in ("params", "batch_stats", "momentum") for k in getattr(a, g))


def _records(path):
    return [json.loads(line) for line in open(path) if line.strip()]


def test_tier_save_promotes_and_roundtrips_bit_exact(tmp_path, tiny_data):
    cfg = _cfg(tmp_path)
    logger = MetricsLogger(cfg.obs.metrics_path, echo=False)
    res = _fit(cfg, tiny_data, logger)
    logger.close()
    ckpt_dir = cfg.train.checkpoint_dir
    assert tier_steps(ckpt_dir) == jax_checkpoint.tier_steps(ckpt_dir) == [4, 8]
    assert tier_map(ckpt_dir) == {"4": "durable", "8": "durable"}
    assert os.listdir(os.path.join(local_tier_dir(ckpt_dir), "rank0")) == []   # promoted
    # Readers need no tier config: a plain manager serves tier steps.
    mngr = CheckpointManager(ckpt_dir)
    assert mngr.all_steps() == [4, 8]
    restored, used = mngr.restore_verified(device="cpu")
    assert used == 8 and _states_equal(restored, res.state)
    assert mngr.metrics(8)["epoch"] == 1 and mngr.saved_world(8) == 1
    assert mngr.verified_steps() == [4, 8]
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from validate_metrics import validate_file
    assert not validate_file(cfg.obs.metrics_path)
    tiers = [r for r in _records(cfg.obs.metrics_path) if r["kind"] == "ckpt_tier"]
    assert [(r["step"], r["tier"]) for r in tiers] == [(4, "local"), (4, "durable"),
                                                       (8, "local"), (8, "durable")]


def test_corrupt_promoted_shard_is_caught_and_falls_back(tmp_path, tiny_data):
    cfg = _cfg(tmp_path)
    _fit(cfg, tiny_data)
    ckpt_dir = cfg.train.checkpoint_dir
    npz = os.path.join(tiered_dir(ckpt_dir), "step_8", "rank0.npz")
    data = bytearray(open(npz, "rb").read())
    data[len(data) // 2] ^= 0xFF   # past the zip headers: a digest must catch it
    with open(npz, "wb") as fh:
        fh.write(data)
    mngr = CheckpointManager(ckpt_dir)
    with pytest.raises(CheckpointCorrupt):
        mngr.restore(8, device="cpu")
    fallbacks = []
    restored, used = mngr.restore_verified(device="cpu",
                                           on_fallback=lambda **kw: fallbacks.append(kw))
    assert used == 4 and restored.step == 4
    assert [f["step"] for f in fallbacks] == [8]


def test_sigterm_mid_promotion_drains_to_durable_restorable(tmp_path, tiny_data):
    """SIGTERM at epoch 0's end while step 4's promotion sleeps in its delay:
    the preemption path drains it; the step is promoted, verified and
    restorable, the ``preempted`` record carries the drain's wait and budget,
    and a resume continues from it."""
    cfg = _cfg(tmp_path, **{"checkpoint.promote_delay_s": "1.0", "train.num_epochs": 3})
    logger = MetricsLogger(cfg.obs.metrics_path, echo=False)
    inject.activate(inject.FaultPlan(sigterm_at_epoch_end=0))
    try:
        with pytest.raises(Preempted) as exc:
            _fit(cfg, tiny_data, logger)
    finally:
        inject.deactivate()
        logger.close()
    assert exc.value.durable_step == 4
    assert tier_steps(cfg.train.checkpoint_dir) == [4]
    preempted = [r for r in _records(cfg.obs.metrics_path) if r["kind"] == "preempted"]
    assert preempted[-1]["durable_step"] == 4
    assert preempted[-1]["drain_budget_s"] == 120.0
    assert 0.5 <= preempted[-1]["drain_wait_s"] <= 60.0
    assert preempted[-1]["drain_timed_out"] is False
    assert CheckpointManager(cfg.train.checkpoint_dir).restore(4, device="cpu").step == 4
    cfg.train.resume = True
    res = _fit(cfg, tiny_data)
    assert [r["epoch"] for r in res.history] == [1, 2] and res.state.step == 12


@pytest.mark.parametrize("case", ["unpromotable", "drain_timeout"])
def test_preempt_without_a_landed_step_reports_no_durable_step(tmp_path, tiny_data, case):
    """The ``durable_step`` a preemption claims matches the LISTING: with
    promotion off the final save never lands; with a promotion slower than
    the drain budget the drain times out having spent the budget. Either way
    ``durable_step`` is None and a ``checkpoint_not_durable`` fault says how
    much of the budget the wait took."""
    over = ({"checkpoint.promote": "false"} if case == "unpromotable" else
            {"checkpoint.promote_delay_s": "3", "checkpoint.drain_timeout_s": "1.0"})
    cfg = _cfg(tmp_path, **over, **{"train.num_epochs": 3})
    logger = MetricsLogger(cfg.obs.metrics_path, echo=False)
    inject.activate(inject.FaultPlan(sigterm_at_epoch_end=0))
    try:
        with pytest.raises(Preempted) as exc:
            _fit(cfg, tiny_data, logger)
    finally:
        inject.deactivate()
        logger.close()
    assert exc.value.durable_step is None
    recs = _records(cfg.obs.metrics_path)
    fault = next(r for r in recs if r["kind"] == "fault"
                 and r["fault"] == "checkpoint_not_durable")
    assert fault["step"] == 4
    assert [r for r in recs if r["kind"] == "preempted"][-1]["durable_step"] is None
    if case == "drain_timeout":
        assert fault["drain_timed_out"] is True and fault["drain_budget_s"] == 1.0
        assert 0.8 <= fault["drain_wait_s"] <= 10.0


def test_instant_drains_never_clobber_the_meaningful_drain_record(tmp_path):
    records = {}
    for side, cls in (("jax", jax_checkpoint.LocalTier), ("torch", LocalTier)):
        tier = cls(str(tmp_path / side / "ckpt"))
        try:
            tier.errors.append("promotion failed")
            assert tier.drain(0.05) is False       # the first failure records
            first = dict(tier.last_drain)
            meaningful = dict(first, wait_s=1.2, timed_out=True)
            tier.last_drain = meaningful
            assert tier.drain(0.05) is False       # an instant no-op keeps it
            assert tier.last_drain is meaningful
        finally:
            tier.close()
        first.pop("wait_s")
        records[side] = first
    assert records["torch"] == records["jax"]


def test_local_tier_dir_namespaces_a_shared_configured_root():
    for args in (("/jobs/a/ckpt", "/local/ssd"), ("/jobs/b/ckpt", "/local/ssd"),
                 ("/jobs/a/ckpt",), ("rel/ckpt", "scratch")):
        assert local_tier_dir(*args) == jax_checkpoint.local_tier_dir(*args)
    a = local_tier_dir("/jobs/a/ckpt", "/local/ssd")
    assert a != local_tier_dir("/jobs/b/ckpt", "/local/ssd")
    assert a.startswith(os.path.abspath("/local/ssd") + os.sep)
    assert local_tier_dir("/jobs/a/ckpt") == "/jobs/a/ckpt_local"


def test_unpromoted_local_save_never_counts_as_durable(tmp_path, tiny_data):
    cfg = _cfg(tmp_path, **{"checkpoint.promote": "false", "train.num_epochs": 1})
    _fit(cfg, tiny_data)
    ckpt_dir = cfg.train.checkpoint_dir
    assert tier_steps(ckpt_dir) == jax_checkpoint.tier_steps(ckpt_dir) == []
    assert tier_map(ckpt_dir) == {"4": "local"}
    mngr = CheckpointManager(ckpt_dir)
    assert mngr.all_steps() == []
    with pytest.raises(FileNotFoundError):
        mngr.restore(device="cpu")
    # A promotion cut off mid-way (rank 1's marker never landed) is not
    # durable either, whatever rank 0 promoted.
    half = os.path.join(tiered_dir(ckpt_dir), "step_12")
    os.makedirs(half)
    with open(os.path.join(half, "promoted.rank0.json"), "w") as fh:
        json.dump({"step": 12, "rank": 0, "world": 2}, fh)
    assert tier_steps(ckpt_dir) == jax_checkpoint.tier_steps(ckpt_dir) == []


def _zero1_state(seed: int) -> TrainState:
    g = torch.Generator().manual_seed(seed)
    shapes = {"conv.weight": (8, 3, 3, 3), "bn.weight": (8,), "fc.weight": (10, 8),
              "fc.bias": (10,)}
    params = {k: torch.randn(s, generator=g) for k, s in shapes.items()}
    momentum = {k: torch.randn(s, generator=g) for k, s in shapes.items()}
    stats = {"bn.running_mean": torch.randn(8, generator=g)}
    return TrainState(params, stats, momentum, step=37)


class _Opt:
    def __init__(self, slots):
        self.slots = slots


def test_zero1_save_at_two_ranks_restores_at_one_and_two_bitwise(tmp_path):
    """Each rank of W = 2 saves its own momentum slices (rank 0 also the
    replicated arrays); the durable step is whole only with both markers,
    restores whole at W = 1, and re-slices at W = 2 into each rank's own
    slices, all bitwise."""
    whole = _zero1_state(0)
    directory = str(tmp_path / "ckpt")
    tiers = [LocalTier(directory, rank=r, world=2) for r in (0, 1)]
    for r, tier in enumerate(tiers):
        slots = UpdateSharding(2, r)
        tier.save_local(40, shard_slots(whole, _Opt(slots)), {"epoch": 4}, slots)
        tier.drain()
        assert tier_steps(directory) == ([] if r == 0 else [40])
        tier.close()
    sliced = UpdateSharding(2, 0)
    assert sliced.spec_for((10,)) == 0 and sliced.spec_for((8, 3, 3, 3)) == 0
    manifests = [json.load(open(os.path.join(tiered_dir(directory), "step_40",
                                             f"rank{r}.manifest.json"))) for r in (0, 1)]
    assert {e["leaf"] for e in manifests[1]["arrays"]} == {
        f"momentum/{k}" for k in whole.momentum}   # rank 1: its slices only
    assert all(e["index"] is not None for e in manifests[1]["arrays"])
    mngr = CheckpointManager(directory)
    assert mngr.saved_world(40) == 2 and mngr.metrics(40) == {"epoch": 4}
    restored = mngr.restore(40, device="cpu")            # W = 1: the whole state
    assert _states_equal(restored, whole)
    for r in (0, 1):                                      # W = 2: each rank's slices
        mine = shard_slots(restored, _Opt(UpdateSharding(2, r)))
        want = shard_slots(whole, _Opt(UpdateSharding(2, r)))
        assert _states_equal(mine, want)
    payload = restore_tier_payload(directory, 40)
    assert all(np.array_equal(payload[f"momentum/{k}"], v.numpy())
               for k, v in whole.momentum.items())
