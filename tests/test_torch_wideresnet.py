"""PyTorch port: WideResNet against the Flax model, and its GraNd routes.

WRN-28-10 at full width on weights ported from a Flax init (batch 1); the
narrow WRN-10-1 and WRN-16-2 with every BatchNorm randomized, in eval and in
train mode (batch statistics against Flax's ``mutable=["batch_stats"]``),
and their batched GraNd against the JAX package's. The route test pins the
kernel table of BASELINE config 4: which kernel each of WRN-28-10's convs
takes at batch 512.
"""

import functools
from collections import Counter
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from data_diet_distributed_tpu.models import create_model as flax_create_model
from data_diet_distributed_tpu.models.wideresnet import WideResNet as FlaxWideResNet
from data_diet_distributed_tpu.ops.grand_batched import \
    batched_grand_scores as flax_batched_grand_scores
from data_diet_distributed_tpu_torch.models import WideResNet, create_model
from data_diet_distributed_tpu_torch.models.resnet import collect_batch_stats
from data_diet_distributed_tpu_torch.ops import grand_batched as gb
from data_diet_distributed_tpu_torch.ops import kernels
from data_diet_distributed_tpu_torch.ops.scores import make_local_scores
from data_diet_distributed_tpu_torch.weights import init_variables, params_from_flax
from test_torch_models import numpy_tree, randomize_bn
from torch_threads import one_intra_op_thread  # noqa: F401

NARROW = {"wrn10_1": (10, 1), "wrn16_2": (16, 2)}


@functools.cache
def _narrow(name: str, batch: int = 4, seed: int = 0):
    """A narrow Flax WRN with BN-randomized variables, the port's with them
    loaded, and a seeded batch (made once per file: the Flax init compiles)."""
    depth, k = NARROW[name]
    fm = FlaxWideResNet(depth=depth, widen_factor=k)
    tm = WideResNet(depth=depth, widen_factor=k).eval()
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, batch).astype(np.int32)
    tree = randomize_bn(jax.jit(fm.init)(jax.random.key(seed), jnp.asarray(x[:1])), rng)
    return fm, tree, tm, params_from_flax(tree, tm), x, y


def test_wrn28_10_matches_flax_at_full_width():
    """36,479,194 parameters at 10 classes, as the Flax model has; logits on
    weights ported from a Flax init, batch 1."""
    fm = flax_create_model("wideresnet28_10", 10)
    tm = create_model("wideresnet28_10", 10)
    assert sum(p.numel() for p in tm.parameters()) == 36_479_194
    assert sum(p.numel() for p in create_model("wideresnet28_10", 100).parameters()) \
        == 36_479_194 + 90 * 641
    x = np.random.default_rng(0).normal(size=(1, 32, 32, 3)).astype(np.float32)
    tree = numpy_tree(jax.jit(fm.init)(jax.random.key(0), jnp.asarray(x)))
    want = np.asarray(jax.jit(fm.apply)(tree, jnp.asarray(x)))
    params_from_flax(tree, tm)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    v = init_variables("wideresnet28_10", 0, "cpu")
    assert v.keys() == tm.state_dict().keys() - {
        k for k in tm.state_dict() if k.endswith("num_batches_tracked")}
    with pytest.raises(ValueError, match="stem"):
        create_model("wideresnet28_10", 10, stem="imagenet")
    with pytest.raises(ValueError, match="6n\\+4"):
        WideResNet(depth=12)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(NARROW))
def test_narrow_wrn_matches_flax(name, train):
    fm, tree, tm, variables, x, _ = _narrow(name)
    if not train:
        want = np.asarray(jax.jit(fm.apply)(tree, jnp.asarray(x)))
        with torch.no_grad():
            got = tm(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        return
    want, updated = jax.jit(partial(fm.apply, train=True, mutable=["batch_stats"]))(
        tree, jnp.asarray(x))
    updated = numpy_tree(updated)["batch_stats"]
    tm.train()
    with torch.no_grad(), collect_batch_stats() as sink:
        got = functional_call(tm, variables, (torch.from_numpy(x),))
    tm.eval()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    names = {mod: path for path, mod in tm.named_modules()}
    assert len(sink) == sum(isinstance(m, torch.nn.BatchNorm2d) for m in tm.modules())
    for mod, (mean, var) in sink.items():
        node = updated
        for part in names[mod].split("."):
            node = node[part]
        m = mod.flax_momentum
        for stat, batch_value in (("mean", mean), ("var", var)):
            running = variables[f"{names[mod]}.running_{stat}"]
            np.testing.assert_allclose(
                (m * running + (1 - m) * batch_value).numpy(), node[stat],
                rtol=1e-4, atol=1e-5, err_msg=f"{names[mod]} {stat}")


@functools.cache
def _jax_grand(name: str):
    fm, tree, _, _, x, y = _narrow(name)
    mask = np.ones(len(x), np.float32)
    mask[-1] = 0.0
    return mask, np.asarray(jax.jit(partial(flax_batched_grand_scores, fm,
                                            use_pallas=False))(
        tree, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask)))


@pytest.mark.parametrize("route", ["two_phase", "fused"])
def test_narrow_wrn_batched_grand_matches_jax(route):
    _, _, tm, variables, x, y = _narrow("wrn10_1")
    mask, want = _jax_grand("wrn10_1")
    args = (variables, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask))
    fn = gb.batched_grand_scores if route == "two_phase" else gb.batched_grand_scores_fused
    got = fn(tm, *args, use_kernels=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-5)
    vmapped = make_local_scores(tm, "grand_vmap", chunk=2)(*args)
    np.testing.assert_allclose(got.numpy(), vmapped.numpy(), rtol=2e-4, atol=1e-5)
    assert got[-1] == 0 and (got[:-1] > 0).all()


def _wrn28_10_layers(batch: int):
    """(record, NHWC x shape, NHWC g shape) of every Conv and BatchNorm of
    WRN-28-10 at CIFAR-100 geometry and ``batch``, from a forward on the meta
    device (shapes only, no arithmetic)."""
    with torch.device("meta"):
        model = create_model("wideresnet28_10", 100)
    names = {mod: path for path, mod in model.named_modules()}
    layers = []

    def hook(mod, args, out):
        nhwc = (lambda t: (t.shape[0], t.shape[2], t.shape[3], t.shape[1]))
        layers.append((gb._record_for(names[mod], mod), nhwc(args[0]), nhwc(out)))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.BatchNorm2d))]
    model(torch.empty((batch, 32, 32, 3), device="meta"))
    for h in handles:
        h.remove()
    return layers


def test_wrn28_10_kernel_routes_at_batch_512(monkeypatch):
    """BASELINE config 4's kernel table: of WRN-28-10's 28 convs the default
    route sends 9 to the direct kernel's v1 entry (stage 1's eight 3x3 convs
    and the 1x1/2 projection 160 -> 320), 7 to v2 (stage 2's unit-stride
    320-channel convs), 7 to the Gram kernel (stage 3's 640-channel convs at
    8x8) and 5 to the plain route (the stem, the 1x1 16 -> 160 projection, and
    stage 2's and 3's 3x3/2 entry convs and stage 3's projection); cat-dot
    takes none of them; the megakernel takes the 15 unit-stride 3x3 convs of
    stages 1 and 2; the 25 BatchNorms come in 4 widths."""
    layers = _wrn28_10_layers(512)
    convs = [(rec, xs, gs) for rec, xs, gs in layers if rec["kind"] == "conv"]
    assert len(convs) == 28

    def routes():
        return {rec["path"]: gb.conv_route(rec, xs, gs, gb._explicit_padding(
            rec["padding"], xs, gs, rec)) for rec, xs, gs in convs}
    table = routes()
    assert Counter(table.values()) == {"v1": 9, "v2": 7, "gram": 7, "plain": 5}
    assert table["stem_conv"] == table["WideBlock_0.proj_conv"] == "plain"
    assert all(table[f"WideBlock_{i}.Conv_{j}"] == "v1" for i in range(4) for j in (0, 1))
    assert table["WideBlock_4.proj_conv"] == "v1"
    assert table["WideBlock_4.Conv_0"] == table["WideBlock_8.Conv_0"] == "plain"
    assert table["WideBlock_8.proj_conv"] == "plain"
    assert all(table[f"WideBlock_{i}.Conv_1"] == "v2" for i in range(4, 8))
    assert all(table[f"WideBlock_{i}.Conv_0"] == "v2" for i in range(5, 8))
    assert all(table[f"WideBlock_{i}.Conv_{j}"] == "gram"
               for i in range(8, 12) for j in (0, 1) if (i, j) != (8, 0))
    # Channel counts off the direct kernel's 64-wide C x K tile reach it.
    assert {xs[-1] % kernels.DIRECT_TILE for rec, xs, gs in convs
            if table[rec["path"]] in ("v1", "v2")} == {16, 32, 0}
    monkeypatch.setattr(gb, "USE_CATDOT", True)
    assert routes() == table
    assert not any(kernels.conv_grad_norm_catdot_eligible(xs, gs, rec["kernel_size"],
                                                          rec["strides"], rec["padding"])
                   for rec, xs, gs in convs)
    mega = [rec["path"] for rec, xs, gs in convs if gb._mega_conv_route(rec, xs, gs)]
    assert len(mega) == 15 and all(
        table[p] in ("v1", "v2") and p.endswith(("Conv_0", "Conv_1")) for p in mega)
    bns = Counter(xs[-1] for rec, xs, gs in layers if rec["kind"] == "bn")
    assert bns == {16: 1, 160: 8, 320: 8, 640: 8}
