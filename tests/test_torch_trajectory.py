"""PyTorch port: ``model.remat`` and the trajectory scores (forgetting, AUM).

Remat must change nothing but memory: parameter names, the forward, a
training step and the batch statistics are bitwise the same with it on and
off, and so are GraNd scores. The trackers are held against the JAX
package's on the same observation sequences, the per-epoch correctness and
margin passes against its steps on the same ported variables, and
``trajectory_scores`` against itself across a seed-boundary preemption.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from data_diet_distributed_tpu.ops import forgetting as jax_forgetting
from data_diet_distributed_tpu.ops.scores import (make_correctness_step,
                                                  make_margin_step)
from data_diet_distributed_tpu_torch import cli
from data_diet_distributed_tpu_torch.config import load_config
from data_diet_distributed_tpu_torch.models import (BasicBlock, ResNet, WideResNet,
                                                    resnet)
from data_diet_distributed_tpu_torch.ops import forgetting
from data_diet_distributed_tpu_torch.ops.grand_batched import batched_grand_scores
from data_diet_distributed_tpu_torch.ops.scores import make_local_scores
from data_diet_distributed_tpu_torch.resilience import inject
from data_diet_distributed_tpu_torch.resilience.preemption import Preempted
from data_diet_distributed_tpu_torch.train import loop
from data_diet_distributed_tpu_torch.train.state import make_optimizer, state_from_variables
from data_diet_distributed_tpu_torch.train.steps import train_step
from test_torch_models import ported
from torch_threads import one_intra_op_thread  # noqa: F401

SMOKE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "configs", "synthetic_smoke.yaml")


@pytest.fixture(autouse=True)
def _disarm_injector():
    yield
    inject.deactivate()


def _pair(name: str, seed: int = 0):
    """The same narrow model with remat off and on, sharing BN-randomized
    variables (every BatchNorm scale, bias and statistic drawn from ``seed``)."""
    def make(remat):
        if name == "resnet":
            return ResNet((1, 1, 1, 1), BasicBlock, width=16, remat=remat)
        return WideResNet(depth=10, widen_factor=1, remat=remat)
    torch.manual_seed(seed)
    plain, rematd = make(False), make(True)
    gen = torch.Generator().manual_seed(seed)
    variables = {}
    for k, v in plain.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        if v.dim() == 1 and not k.startswith("classifier"):
            base = 1.0 if k.endswith((".weight", "running_var")) else 0.0
            v = base + 0.2 * torch.rand(v.shape, generator=gen)
        variables[k] = v.clone()
    return plain.eval(), rematd.eval(), variables


def _batch(n: int = 6, hw: int = 16, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(n, hw, hw, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, n).astype(np.int64))
    mask = torch.ones(n)
    mask[-1] = 0.0
    return {"image": x, "label": y, "mask": mask}


@pytest.mark.parametrize("name", ["resnet", "wrn"])
def test_remat_changes_no_name_and_no_bit_of_a_training_step(name):
    plain, rematd, variables = _pair(name)
    assert list(plain.state_dict()) == list(rematd.state_dict())
    assert [n for n, _ in plain.named_parameters()] == \
        [n for n, _ in rematd.named_parameters()]
    cfg = load_config(None, ["train.half_precision=false", "optim.lr=0.1"])
    batch = _batch()
    out = {}
    for key, model in (("plain", plain), ("remat", rematd)):
        state = state_from_variables(variables, model)
        metrics = [train_step(model, make_optimizer(cfg, 2), state, batch)
                   for _ in range(2)]
        out[key] = (metrics, state)
    (m0, s0), (m1, s1) = out["plain"], out["remat"]
    assert all(torch.equal(a["loss"], b["loss"]) for a, b in zip(m0, m1))
    for group in ("params", "batch_stats", "momentum"):
        a, b = getattr(s0, group), getattr(s1, group)
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a), group
    assert not torch.equal(s0.params["classifier.weight"],
                           variables["classifier.weight"])   # the steps moved it


class _CountingSink(dict):
    def __init__(self):
        super().__init__()
        self.writes = 0

    def __setitem__(self, key, value):
        self.writes += 1
        super().__setitem__(key, value)


@pytest.mark.parametrize("name", ["resnet", "wrn"])
def test_remat_records_batch_statistics_once(name):
    """The recompute in the backward pass runs every BatchNorm again: it must
    not record its statistics a second time (the backward here runs inside
    the collecting block, where a recompute would see the sink)."""
    plain, rematd, variables = _pair(name)
    batch = _batch()
    n_bn = sum(isinstance(m, torch.nn.BatchNorm2d) for m in plain.modules())
    seen = {}
    for key, model in (("plain", plain), ("remat", rematd)):
        model.train()
        params = {k: v.clone().requires_grad_() for k, v in variables.items()
                  if k in dict(model.named_parameters())}
        sink = _CountingSink()
        token = resnet._STATS_SINK.set(sink)
        try:
            logits = torch.func.functional_call(model, {**variables, **params},
                                                (batch["image"],))
            grads = torch.autograd.grad(logits.square().sum(), list(params.values()))
        finally:
            resnet._STATS_SINK.reset(token)
        model.eval()
        assert sink.writes == n_bn == len(sink)
        seen[key] = (logits, grads, [sink[m] for m in model.modules() if m in sink])
    (l0, g0, st0), (l1, g1, st1) = seen["plain"], seen["remat"]
    assert torch.equal(l0, l1) and all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
               for a, b in zip(st0, st1))


@pytest.mark.parametrize("name", ["resnet", "wrn"])
def test_grand_scores_with_remat_equal_without(name):
    plain, rematd, variables = _pair(name, seed=1)
    b = _batch(seed=1)
    args = (variables, b["image"], b["label"], b["mask"])
    for model in (plain, rematd):
        model.eval()
    assert torch.equal(batched_grand_scores(plain, *args, use_kernels=True),
                       batched_grand_scores(rematd, *args, use_kernels=True))
    # grand_vmap in train mode runs under torch.func, which refuses
    # checkpointing: the remat model scores without it, to the bit.
    want = make_local_scores(plain, "grand_vmap", chunk=3, eval_mode=False)(*args)
    got = make_local_scores(rematd, "grand_vmap", chunk=3, eval_mode=False)(*args)
    assert torch.equal(want, got) and bool(torch.isfinite(got).all())


def test_trackers_bitwise_jax():
    rng = np.random.default_rng(0)
    n = 50
    for port_cls, jax_cls, draw in (
            (forgetting.ForgettingTracker, jax_forgetting.ForgettingTracker,
             lambda: rng.random(n) < 0.6),
            (forgetting.AUMTracker, jax_forgetting.AUMTracker,
             lambda: rng.uniform(-1, 1, n).astype(np.float32))):
        ours, theirs = port_cls(n), jax_cls(n)
        for _ in range(7):
            obs = draw()
            ours.update(obs)
            theirs.update(obs)
        assert ours.updates == theirs.updates == 7
        got, want = ours.scores(), theirs.scores()
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        for bad in (np.zeros(n + 1), np.zeros((n, 1))):
            with pytest.raises(ValueError, match="shape") as ours_err:
                ours.update(bad)
            with pytest.raises(ValueError, match="shape") as jax_err:
                theirs.update(bad)
            assert str(ours_err.value) == str(jax_err.value)
    t = forgetting.ForgettingTracker(4)   # the JAX package's hand sequence
    for correct in ([1, 1, 1, 0], [1, 0, 0, 0], [1, 1, 1, 0], [1, 1, 0, 0]):
        t.update(np.array(correct, bool))
    np.testing.assert_array_equal(t.scores(), [0.0, 1.0, 2.0, 5.0])


def test_epoch_passes_match_jax_steps():
    """The correctness and margin passes of ``trajectory_scores`` against the
    JAX package's ``make_correctness_step`` / ``make_margin_step`` on the same
    ported variables (a narrow ResNet, BN randomized)."""
    fm, tree, tm, variables, x, y = ported("narrow", 8, seed=2)
    mask = np.ones(8, np.float32)
    mask[-2:] = 0.0
    batch = {"image": jnp.asarray(x), "label": jnp.asarray(y), "mask": jnp.asarray(mask)}
    args = (variables, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask))
    want_c = np.asarray(make_correctness_step(fm, None)(tree, batch))
    got_c = make_local_scores(tm, "correctness")(*args).numpy()
    np.testing.assert_array_equal(got_c, want_c)
    want_m = np.asarray(make_margin_step(fm, None)(tree, batch))
    got_m = make_local_scores(tm, "margin")(*args).numpy()
    np.testing.assert_allclose(got_m, want_m, rtol=0, atol=1e-6)
    assert np.any(got_m != 0)


def _traj_cfg(tmp_path, method: str, *extra):
    return load_config(None, [
        "data.dataset=synthetic", "data.synthetic_size=128", "data.batch_size=32",
        "model.arch=tiny_cnn", "optim.lr=0.1", "train.half_precision=false",
        "train.log_every_steps=1000", f"train.checkpoint_dir={tmp_path}/ckpt",
        f"score.method={method}", "score.pretrain_epochs=2", "score.seeds=[0,1]",
        *extra])


class _Events:
    """A ``log`` callable that keeps every record."""

    def __init__(self):
        self.records = []

    def __call__(self, kind, **fields):
        self.records.append({"kind": kind, **fields})

    def of(self, kind):
        return [e for e in self.records if e["kind"] == kind]


@pytest.mark.parametrize("method", ["forgetting", "aum"])
def test_trajectory_scores_resume_bitwise_after_seed_preemption(tmp_path, method):
    base_cfg = _traj_cfg(tmp_path / "base", method)
    train_ds, _ = loop.load_data_for(base_cfg)
    base, base_t = loop.compute_scores(base_cfg, train_ds, device="cpu",
                                       stages=loop.pipeline_stages(base_cfg))
    assert base.shape == (128,) and base.dtype == np.float32 and base_t["passes"] == 2
    cfg = _traj_cfg(tmp_path / "cut", method)
    inject.activate(inject.FaultPlan(sigterm_after_seed_scores=1))
    with pytest.raises(Preempted):
        loop.compute_scores(cfg, train_ds, device="cpu", stages=loop.pipeline_stages(cfg))
    inject.deactivate()
    assert os.listdir(f"{tmp_path}/cut/ckpt_score_partials") == ["seed0.npz"]
    ev = _Events()
    scores, t = loop.compute_scores(cfg, train_ds, device="cpu", log=ev,
                                    stages=loop.pipeline_stages(cfg, ev))
    (resumed,) = ev.of("score_seeds_resumed")
    assert resumed["done"] == [0] and resumed["todo"] == [1] and t["passes"] == 1
    assert [e["seed"] for e in ev.of(f"{method}_seed_done")] == [1]
    np.testing.assert_array_equal(scores, base)


def test_trajectory_scores_refusals_and_fit_epoch_hook(tmp_path):
    cfg = _traj_cfg(tmp_path, "grand")
    train_ds, _ = loop.load_data_for(cfg)
    with pytest.raises(ValueError, match="forgetting/aum"):
        loop.forgetting_scores(cfg, train_ds, device="cpu")
    cfg = _traj_cfg(tmp_path, "forgetting")
    cfg.score.pretrain_epochs = 0
    with pytest.raises(ValueError, match="pretrain_epochs"):
        loop.trajectory_scores(cfg, train_ds, device="cpu")
    calls = []
    res = loop.fit(cfg, train_ds, None, device="cpu", num_epochs=2,
                   epoch_hook=lambda model, state, epoch: calls.append(
                       (type(model).__name__, state.step, epoch)))
    assert calls == [("TinyCNN", 4, 0), ("TinyCNN", 8, 1)] and res.state.step == 8


@pytest.mark.parametrize("method", ["forgetting", "aum"])
def test_cli_score_runs_trajectory_methods(tmp_path, capsys, method):
    """``cli score`` on the CPU, twice: the same bits; forgetting's never-learned
    rows pinned at ``updates + 1``, AUM's margins in [-1, 1]."""
    outs = []
    for run in range(2):
        ckpt = tmp_path / f"run{run}"
        assert cli.main(["score", "--config", SMOKE, "--device", "cpu",
                         "data.synthetic_size=96", "data.batch_size=32",
                         f"score.method={method}", "score.pretrain_epochs=2",
                         "score.seeds=[0]", f"train.checkpoint_dir={ckpt}"]) == 0
        with np.load(f"{ckpt}_scores.npz") as f:
            assert str(f["method"]) == method
            outs.append(f["scores"])
    assert '"event": "scores_saved"' in capsys.readouterr().out
    np.testing.assert_array_equal(outs[0], outs[1])
    s = outs[0]
    assert s.shape == (96,) and np.isfinite(s).all()
    if method == "forgetting":
        # Two observations: 0 or 1 forgetting events, or never learned (3).
        assert set(np.unique(s)) <= {0.0, 1.0, 3.0}
    else:
        assert (np.abs(s) <= 1.0).all() and s.std() > 0
