"""PyTorch port: models and the weight port against the Flax models.

Inputs are made with numpy from a seed; Flax variables cross over as numpy
trees (``params_from_flax``), so the port never sees JAX. The helpers at the
top are shared with the other ``test_torch_*`` files.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from data_diet_distributed_tpu.models import create_model as flax_create_model
from data_diet_distributed_tpu.models.resnet import BasicBlock as FlaxBasicBlock
from data_diet_distributed_tpu.models.resnet import BottleneckBlock as FlaxBottleneckBlock
from data_diet_distributed_tpu.models.resnet import ResNet as FlaxResNet
from data_diet_distributed_tpu_torch.models import (BasicBlock, BottleneckBlock, ResNet,
                                                    create_model)
from data_diet_distributed_tpu_torch.weights import (init_variables,
                                                     params_from_flax)


def numpy_tree(tree):
    """A Flax variables pytree as nested dicts of numpy arrays."""
    return jax.tree.map(np.asarray, jax.device_get(tree))


def randomize_bn(tree, rng):
    """Random scale/bias/mean/var for every BatchNorm: at init the closing BN
    scale is zero, which would zero the cotangent of half the convs."""
    tree = numpy_tree(tree)

    def walk(params, stats):
        for key, sub in params.items():
            if not isinstance(sub, dict):
                continue
            if "scale" in sub and "mean" in stats.get(key, {}):
                c = sub["scale"].shape
                sub["scale"] = rng.normal(1.0, 0.3, c).astype(np.float32)
                sub["bias"] = rng.normal(0.0, 0.3, c).astype(np.float32)
                stats[key]["mean"] = rng.normal(0.0, 0.3, c).astype(np.float32)
                stats[key]["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            else:
                walk(sub, stats.get(key, {}))

    walk(tree["params"], tree["batch_stats"])
    return tree


def flax_and_torch(name: str):
    """(flax model, torch model) pairs of the small test zoo, fp32."""
    if name == "tiny":
        return flax_create_model("tiny_cnn", 10), create_model("tiny_cnn", 10)
    if name == "narrow":
        return (FlaxResNet((1, 1, 1, 1), FlaxBasicBlock, width=16),
                ResNet((1, 1, 1, 1), BasicBlock, width=16).eval())
    if name == "narrow_bottleneck":
        # ResNet-50's parts: bottleneck blocks, the 7x7/2 stem and max-pool.
        return (FlaxResNet((1, 1, 1, 1), FlaxBottleneckBlock, width=8, stem="imagenet"),
                ResNet((1, 1, 1, 1), BottleneckBlock, width=8, stem="imagenet").eval())
    return flax_create_model("resnet18", 10), create_model("resnet18", 10)


def ported(name: str, batch: int, seed: int = 0):
    """Flax model + BN-randomized numpy variables, the torch model with them
    loaded, and a seeded batch."""
    fm, tm = flax_and_torch(name)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, batch).astype(np.int32)
    init = jax.jit(fm.init, static_argnames=("train",))
    tree = randomize_bn(init(jax.random.key(seed), jnp.asarray(x[:1]), train=False),
                        rng)
    variables = params_from_flax(tree, tm)
    return fm, tree, tm, variables, x, y


@pytest.mark.parametrize("name,batch", [("tiny", 4), ("narrow", 4), ("resnet18", 2),
                                        ("narrow_bottleneck", 4)])
def test_logits_match_flax(name, batch):
    fm, tree, tm, _, x, _ = ported(name, batch)
    want = np.asarray(fm.apply(tree, jnp.asarray(x), train=False))
    got = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_features_and_channels_last():
    _, _, tm, _, x, _ = ported("tiny", 2)
    logits, feats = tm(torch.from_numpy(x), capture_features=True)
    assert logits.dtype == torch.float32 and feats.shape == (2, 32)
    seen = []
    h = tm.Conv_0.register_forward_hook(lambda m, a, o: seen.append(o))
    tm(torch.from_numpy(x))
    h.remove()
    assert seen[0].is_contiguous(memory_format=torch.channels_last)


def test_half_precision_runs_bf16_with_fp32_params():
    model = create_model("tiny_cnn", 10, half_precision=True)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    seen = []
    h = model.Conv_1.register_forward_hook(lambda m, a, o: seen.append(o.dtype))
    logits = model(torch.zeros(2, 32, 32, 3))
    h.remove()
    assert seen == [torch.bfloat16] and logits.dtype == torch.float32


def test_params_from_flax_is_strict():
    fm, tree, tm, _, _, _ = ported("tiny", 1)
    del tree["params"]["classifier"]["bias"]
    with pytest.raises(RuntimeError, match="Missing key"):
        params_from_flax(tree, tm)
    tree = numpy_tree(fm.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                              train=False))
    tree["params"]["classifier"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="unmapped"):
        params_from_flax(tree, tm)


def test_init_variables_recipe():
    v = init_variables("resnet18", 3, "cpu")
    again = init_variables("resnet18", 3, "cpu")
    other = init_variables("resnet18", 4, "cpu")
    assert all(torch.equal(v[k], again[k]) for k in v)
    assert not torch.equal(v["stem_conv.weight"], other["stem_conv.weight"])
    for i in range(8):   # the BN closing each residual branch starts at zero
        assert not v[f"BasicBlock_{i}.BatchNorm_1.weight"].any()
        assert (v[f"BasicBlock_{i}.BatchNorm_0.weight"] == 1).all()
    w = v["BasicBlock_0.Conv_0.weight"]
    std = (2.0 / (64 * 9)) ** 0.5
    assert w.abs().max() <= 2 * std / 0.87962566 + 1e-6    # truncated at 2 sigma
    assert abs(float(w.std()) - std) < 0.1 * std           # He-normal scale
    assert not v["classifier.bias"].any()
    model = create_model("resnet18", 10)
    model.load_state_dict(v, strict=True)


def test_unknown_arch_and_remat_raise():
    with pytest.raises(ValueError, match="unknown arch"):
        create_model("wideresnet28_10", 10)
    with pytest.raises(NotImplementedError):
        create_model("resnet18", 10, remat=True)
