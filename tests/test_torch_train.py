"""PyTorch port: the training slice against the JAX package, step by step.

Schedule, optimizer, augmentation, batch assembly, train steps and
``evaluate``, each on the same numpy-seeded inputs on both sides, fp32 on the
CPU; tolerances are stated at each comparison. ``fit`` and train-mode scores
are in ``test_torch_fit.py``. The helpers at the top are shared with it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from data_diet_distributed_tpu.config import load_config as flax_load_config
from data_diet_distributed_tpu.data import datasets as flax_datasets
from data_diet_distributed_tpu.data.augment import augment_images
from data_diet_distributed_tpu.data.pipeline import \
    iterate_batches as flax_iterate_batches
from data_diet_distributed_tpu.parallel.mesh import make_mesh
from data_diet_distributed_tpu.train import loop as flax_loop
from data_diet_distributed_tpu.train import state as flax_state
from data_diet_distributed_tpu.data.pipeline import BatchSharder
from data_diet_distributed_tpu.train.steps import make_train_step as flax_make_train_step
from data_diet_distributed_tpu_torch.config import load_config
from data_diet_distributed_tpu_torch.data.augment import apply_augment, draw_augment
from data_diet_distributed_tpu_torch.data.datasets import ArrayDataset
from data_diet_distributed_tpu_torch.data.pipeline import (ResidentBatches,
                                                           iterate_batches, to_device)
from data_diet_distributed_tpu_torch.train import loop
from data_diet_distributed_tpu_torch.train.state import (TrainState, make_optimizer,
                                                         make_schedule,
                                                         state_from_variables)
from data_diet_distributed_tpu_torch.train.steps import train_step
from data_diet_distributed_tpu_torch.weights import params_from_flax
from test_torch_models import numpy_tree, ported

BASE = ["data.dataset=synthetic", "data.synthetic_size=200", "data.batch_size=64",
        "data.eval_batch_size=64", "model.arch=tiny_cnn", "optim.lr=0.1",
        "train.half_precision=false", "train.chunk_steps=0",
        "train.log_every_steps=1000", "score.pretrain_epochs=0"]


def both_cfgs(over):
    return flax_load_config(None, list(over)), load_config(None, list(over))


def flax_train_state(fm, tree, cfg, steps_per_epoch):
    return flax_state.TrainState.create(
        apply_fn=fm.apply, params=jax.tree.map(jnp.asarray, tree["params"]),
        batch_stats=jax.tree.map(jnp.asarray, tree["batch_stats"]),
        tx=flax_state.make_optimizer(cfg, steps_per_epoch))


def to_port(flax_state_):
    return params_from_flax(numpy_tree({"params": flax_state_.params,
                                        "batch_stats": flax_state_.batch_stats}))


def assert_variables_close(got: dict, want: dict, rtol: float, atol: float):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k].numpy(),
                                   rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("section", ["OptimConfig", "TrainConfig"])
def test_optim_and_train_config_match_jax(section):
    import dataclasses

    from data_diet_distributed_tpu import config as flax_config
    from data_diet_distributed_tpu_torch import config as port_config
    want = {f.name: f.default for f in dataclasses.fields(getattr(flax_config, section))}
    got = {f.name: f.default for f in dataclasses.fields(getattr(port_config, section))}
    assert got == want


@pytest.mark.parametrize("over", [["optim.warmup_epochs=5"], ["optim.warmup_epochs=-1"],
                                  ["train.chunk_steps=-1"]])
def test_config_validations_match_jax(over):
    with pytest.raises(ValueError) as want:
        flax_load_config(None, ["train.num_epochs=5", *over])
    with pytest.raises(ValueError) as got:
        load_config(None, ["train.num_epochs=5", *over])
    assert str(got.value).split(",")[0] == str(want.value).split(",")[0]


@pytest.mark.parametrize("over", [
    [],                                                      # cosine over num_epochs
    ["optim.warmup_epochs=2"],                               # linear warmup into it
    ["optim.cosine_t_max_epochs=7", "optim.warmup_epochs=1"],
    ["optim.cosine_t_max_epochs=3"],                         # horizon before the end
])
def test_schedule_matches_optax_at_every_step(over):
    jcfg, cfg = both_cfgs(["train.num_epochs=5", "optim.lr=0.3", *over])
    spe = 7
    steps = np.arange(5 * spe + 3, dtype=np.int32)
    want = np.asarray(flax_state.make_schedule(jcfg, spe)(jnp.asarray(steps)))
    got_fn = make_schedule(cfg, spe)
    got = np.array([got_fn(int(s)) for s in steps], np.float32)
    # float32 on both sides; cos may differ by an ulp (abs ~3e-9 at lr 0.3).
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8)


def test_schedule_refuses_warmup_past_horizon_by_name():
    _, cfg = both_cfgs(["train.num_epochs=5", "optim.warmup_epochs=2"])
    cfg.train.num_epochs = 2      # as a short scoring pretrain shortens it
    with pytest.raises(ValueError, match="warmup_epochs"):
        make_schedule(cfg, 4)


@pytest.mark.parametrize("clip,nesterov", [(None, False), (1.0, False), (None, True),
                                           (1.0, True)])
def test_optimizer_updates_match_optax(clip, nesterov):
    over = ["train.num_epochs=2", "optim.lr=0.1", "optim.weight_decay=0.01",
            f"optim.nesterov={str(nesterov).lower()}"]
    if clip:
        over.append(f"optim.grad_clip_norm={clip}")
    jcfg, cfg = both_cfgs(over)
    rng = np.random.default_rng(0)
    shapes = {"Conv_0.weight": (4, 3, 3, 3), "BatchNorm_0.weight": (4,),
              "BatchNorm_0.bias": (4,), "classifier.weight": (10, 4),
              "classifier.bias": (10,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    # Global norms ~0.64, 1.3, 2.6: the clip at 1.0 leaves the first step alone.
    grads = [{k: rng.normal(scale=scale, size=s).astype(np.float32)
              for k, s in shapes.items()} for scale in (0.05, 0.1, 0.2)]
    tx = flax_state.make_optimizer(jcfg, 5)
    jp = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jp)
    state = TrainState(params={k: torch.from_numpy(v.copy()) for k, v in params.items()},
                       batch_stats={},
                       momentum={k: torch.zeros(s) for k, s in shapes.items()})
    sgd = make_optimizer(cfg, 5)
    for g in grads:
        upd, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        sgd.update(state, {k: torch.from_numpy(v) for k, v in g.items()})
    assert state.step == 3
    for k in shapes:
        np.testing.assert_allclose(state.params[k].numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("crop_pad,flip", [(4, True), (2, False), (0, True)])
def test_augment_apply_bitwise_equals_jax_on_its_draws(crop_pad, flip):
    rng = np.random.default_rng(1)
    images = rng.normal(size=(6, 8, 8, 3)).astype(np.float32)
    seed, step = 3, 7
    want = np.asarray(augment_images(step, jnp.asarray(images), crop_pad=crop_pad,
                                     flip=flip, seed=seed))
    key = jax.random.fold_in(jax.random.key(seed), step)
    k_flip, k_crop = jax.random.split(key)
    flips = (torch.from_numpy(np.asarray(jax.random.bernoulli(k_flip, 0.5, (6,))))
             if flip else None)
    offsets = (torch.from_numpy(np.asarray(
        jax.random.randint(k_crop, (6, 2), 0, 2 * crop_pad + 1))).long()
        if crop_pad else None)
    got = apply_augment(torch.from_numpy(images), flips, offsets, crop_pad)
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)


def test_augment_draws_are_a_function_of_seed_and_step():
    a = draw_augment(3, 7, 64, 4, True)
    b = draw_augment(3, 7, 64, 4, True)
    c = draw_augment(3, 8, 64, 4, True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[1], c[1])
    assert a[0].dtype == torch.bool and 0 < int(a[0].sum()) < 64
    assert int(a[1].min()) >= 0 and int(a[1].max()) <= 8 and a[1].shape == (64, 2)


@pytest.mark.parametrize("shuffle", [False, True])
def test_host_and_resident_batches_equal_jax_batches(shuffle):
    images, labels = flax_datasets._synthetic(45, 10, 2, "train")
    idx = (np.arange(45) * 3 + 5).astype(np.int32)
    ds = ArrayDataset(images, labels, idx, 10)
    fds = flax_datasets.ArrayDataset(images, labels, idx, 10)
    kw = {"shuffle": shuffle, "seed": 4, "epoch": 2}
    want = list(flax_iterate_batches(fds, 16, **kw))
    host = list(iterate_batches(ds, 16, **kw))
    resident = list(ResidentBatches(ds, 16, "cpu")(**kw))
    assert len(want) == len(host) == len(resident) == 3
    for w, h, r in zip(want, host, resident):
        for k in ("image", "label", "index", "mask"):
            assert np.array_equal(h[k], w[k]), k
            assert np.array_equal(r[k].numpy(), w[k]), k


# (arch, loss rtol after the first step, atol of the variables after 3 steps).
# tiny_cnn: the stated tolerances. The narrow ResNet's 32x32 stage-1 maps make
# BatchNorm's backward reduce 16,384 values a channel, where the JAX CPU
# reference's fp32 gradients stray from float64 while the port's stay within
# 1e-5 of it (test_train_step_gradients_match_float64); three steps at lr 0.1
# carry the two sides' variables farther apart than atol 1e-6.
STEP_CASES = [("tiny", 1e-5, 1e-6), ("narrow", 5e-4, 3e-3)]


@pytest.mark.parametrize("name,loss_rtol,atol", STEP_CASES)
def test_three_train_steps_match_jax(name, loss_rtol, atol):
    """Three steps of B=16 over 40 examples (the third a padded tail of 8) from
    BN-randomized variables: the first loss within rtol 1e-5, the later ones
    within ``loss_rtol``; params and batch_stats within rtol 1e-4 and
    ``atol``."""
    fm, tree, tm, variables, x, y = ported(name, 40, seed=3)
    jcfg, cfg = both_cfgs(["train.num_epochs=1", "optim.lr=0.1"])
    ds = ArrayDataset(x, y, np.arange(40, dtype=np.int32), 10)
    batches = list(iterate_batches(ds, 16))
    jstate = flax_train_state(fm, tree, jcfg, 3)
    jstep = flax_make_train_step(fm)
    state = state_from_variables(variables, tm)
    sgd = make_optimizer(cfg, 3)
    for i, b in enumerate(batches):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        m = train_step(tm, sgd, state, to_device(b, "cpu"))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5 if i == 0 else loss_rtol)
        assert float(m["correct"]) == float(jm["correct"])
        assert float(m["examples"]) == float(jm["examples"])
    assert state.step == int(jstate.step) == 3
    assert_variables_close(state.variables, to_port(jstate), rtol=1e-4, atol=atol)


def test_train_step_gradients_match_float64():
    """The port's fp32 train-mode gradients of the narrow ResNet against the
    same computation in float64: rtol 1e-5 of each tensor's largest entry."""
    _, _, tm, variables, x, y = ported("narrow", 16, seed=3)
    names = [n for n, _ in tm.named_parameters()]

    def grads(model, dtype):
        model.dtype = dtype
        model.to(dtype).train()
        params = {k: variables[k].to(dtype).requires_grad_() for k in names}
        stats = {k: v.to(dtype) for k, v in variables.items() if k not in names}
        logits = torch.func.functional_call(model, {**params, **stats},
                                            (torch.from_numpy(x).to(dtype),))
        loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y).long())
        return dict(zip(names, torch.autograd.grad(loss, list(params.values()))))

    g32 = grads(tm, torch.float32)
    g64 = grads(tm, torch.float64)
    for k in names:
        scale = float(g64[k].abs().max())
        np.testing.assert_allclose(g32[k].double().numpy(), g64[k].numpy(), rtol=0,
                                   atol=1e-5 * scale, err_msg=k)


def test_evaluate_matches_jax():
    fm, tree, tm, variables, x, y = ported("tiny", 40, seed=5)
    jcfg, _ = both_cfgs(["train.num_epochs=1"])
    idx = np.arange(40, dtype=np.int32)
    want = flax_loop.evaluate(fm, flax_train_state(fm, tree, jcfg, 1),
                              flax_datasets.ArrayDataset(x, y, idx, 10),
                              BatchSharder(make_mesh(None)), 16)
    got = loop.evaluate(tm, state_from_variables(variables, tm),
                        ArrayDataset(x, y, idx, 10), 16, device="cpu")
    assert got["examples"] == want["examples"] == 40
    assert got["accuracy"] == want["accuracy"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
