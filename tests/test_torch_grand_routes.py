"""PyTorch port: every GraNd route against the JAX package's and the port's default.

The fused and megakernel routes are held against JAX
``batched_grand_scores_fused(use_pallas=True)`` (its Pallas kernels in
interpret mode) on converted weights; ``grand_vmap`` against JAX
``make_grand_step``; the last-layer kernel route against JAX's Pallas route.
Every ``DDT_GRAND_*`` route is held against the port's default two-phase route
at ResNet-18 / CIFAR-10 geometry with one example, where the route logs pin
each route's kernel launches per batch. Toggles are patched as module
attributes, as ``tests/test_grand_batched.py`` does on the JAX side.
"""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from data_diet_distributed_tpu.ops import grand_batched as flax_grand_batched
from data_diet_distributed_tpu.ops.scores import make_grand_step
from data_diet_distributed_tpu.ops.scores import \
    make_local_scores as flax_make_local_scores
from data_diet_distributed_tpu_torch import cli
from data_diet_distributed_tpu_torch.config import load_config
from data_diet_distributed_tpu_torch.data.datasets import ArrayDataset, _synthetic
from data_diet_distributed_tpu_torch.models import create_model
from data_diet_distributed_tpu_torch.ops import grand_batched as gb
from data_diet_distributed_tpu_torch.ops.scores import make_local_scores
from data_diet_distributed_tpu_torch.serve.engine import ServeEngine
from data_diet_distributed_tpu_torch.weights import init_variables, params_from_flax
from test_torch_cli import SMOKE
from test_torch_models import flax_and_torch, randomize_bn

TOGGLES = ("GROUP_CONV", "GROUP_BN", "USE_BN_KERNEL", "USE_CATDOT", "STEM_XLA",
           "FUSED_BWD", "MEGAKERNEL")


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread for this file's small ops: the test workers share
    the machine's cores, and oversubscribed thread pools make each op wait."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seeded_tree(fm, x, rng):
    """Flax variables of ``fm`` drawn with numpy: the structure from
    ``jax.eval_shape`` of ``init`` (a trace, no compile), kernels normal with
    std 1/sqrt(fan-in), biases 0, then every BatchNorm randomized."""
    shapes = jax.eval_shape(lambda xx: fm.init(jax.random.key(0), xx, train=False),
                            jax.ShapeDtypeStruct((1,) + x.shape[1:], jnp.float32))

    def draw(path, leaf):
        if len(leaf.shape) >= 2:
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.normal(size=leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        ones = path[-1].key in ("scale", "var")
        return np.full(leaf.shape, 1.0 if ones else 0.0, np.float32)
    return randomize_bn(jax.tree_util.tree_map_with_path(draw, shapes), rng)


@pytest.fixture(scope="module")
def nets():
    """name -> (flax model, BN-randomized variables, torch model, its variables,
    a seeded batch of 8 16x16 images, labels), made once per module."""
    cache = {}

    def get(name):
        if name not in cache:
            fm, tm = flax_and_torch(name)
            rng = np.random.default_rng(1)
            x = rng.normal(size=(8, 16, 16, 3)).astype(np.float32)
            y = rng.integers(0, 10, 8).astype(np.int32)
            tree = _seeded_tree(fm, x, rng)
            cache[name] = fm, tree, tm, params_from_flax(tree, tm), x, y
        return cache[name]
    return get


@pytest.fixture(scope="module")
def jax_fused(nets):
    """name -> JAX ``batched_grand_scores_fused(use_pallas=True)`` scores with
    megakernel off and on, from one jitted call per net."""
    cache = {}

    def get(name, megakernel):
        if name not in cache:
            fm, tree, _, _, x, y = nets(name)
            both = jax.jit(lambda t, xx, yy, mm: tuple(
                flax_grand_batched.batched_grand_scores_fused(
                    fm, t, xx, yy, mm, use_pallas=True, megakernel=mega)
                for mega in (False, True)))
            cache[name] = [np.asarray(r) for r in both(
                tree, jnp.asarray(x), jnp.asarray(y), jnp.asarray(_mask(len(x))))]
        return cache[name][int(megakernel)]
    return get


def _torch_batch(x, y, mask):
    return torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask)


def _mask(n):
    mask = np.ones(n, np.float32)
    mask[-2:] = 0.0
    return mask


@pytest.mark.parametrize("name,megakernel", [
    ("tiny", False), ("tiny", True), ("narrow", False), ("narrow", True)])
def test_fused_routes_match_jax(nets, jax_fused, name, megakernel):
    _, _, tm, variables, x, y = nets(name)
    mask = _mask(len(x))
    want = jax_fused(name, megakernel)
    log = []
    got = gb.batched_grand_scores_fused(tm, variables, *_torch_batch(x, y, mask),
                                        use_kernels=True, megakernel=megakernel,
                                        route_log=log)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-5)
    assert (got.numpy()[-2:] == 0).all() and (got.numpy()[:-2] > 0).all()
    # tiny_cnn's convs are strided: only the narrow ResNet has megakernel layers.
    assert ("mega" in dict(log).values()) == (megakernel and name == "narrow")


def test_grand_vmap_matches_jax_and_the_batched_route(nets):
    fm, tree, tm, variables, x, y = nets("tiny")
    x, y, mask = x[:4], y[:4], _mask(4)
    batch = {"image": jnp.asarray(x), "label": jnp.asarray(y), "mask": jnp.asarray(mask)}
    want = np.asarray(make_grand_step(fm, chunk=4)(tree, batch))
    got = make_local_scores(tm, "grand_vmap", chunk=3)(variables, *_torch_batch(x, y, mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-5)
    assert (got.numpy()[-2:] == 0).all()
    batched = gb.batched_grand_scores(tm, variables, *_torch_batch(x, y, mask))
    np.testing.assert_allclose(got.numpy(), batched.numpy(), rtol=2e-4, atol=1e-5)


def test_grand_last_layer_kernel_route_matches_jax(nets):
    fm, tree, tm, variables, x, y = nets("tiny")
    mask = _mask(len(x))
    want = np.asarray(flax_make_local_scores(fm, "grand_last_layer", use_pallas=True)(
        tree, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask)))
    got = make_local_scores(tm, "grand_last_layer", use_kernels=True)(
        variables, *_torch_batch(x, y, mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert (got.numpy()[-2:] == 0).all()


@pytest.fixture(scope="module")
def resnet18_one():
    """ResNet-18 at CIFAR-10 geometry, BN randomized, one example."""
    model = create_model("resnet18", 10)
    v = init_variables("resnet18", 0, "cpu")
    gen = torch.Generator().manual_seed(0)
    for k, t in v.items():
        if t.dim() == 1 and not k.startswith("classifier"):
            if k.endswith("running_var"):
                v[k] = torch.rand(t.shape, generator=gen) + 0.5
            else:
                v[k] = (1.0 if k.endswith(".weight") else 0.0) + 0.3 * torch.randn(
                    t.shape, generator=gen)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 32, 32, 3))
                         .astype(np.float32))
    y, mask = torch.tensor([3]), torch.ones(1)
    base = gb.batched_grand_scores(model, v, x, y, mask, use_kernels=True)
    return model, v, x, y, mask, base


# Per route: the toggles, then the route log's count per route at ResNet-18
# geometry: one entry per conv layer or group, "bn" one per stacked-BN launch.
# Kernel launches per batch are direct = v1 + v2, Gram = gram, cat-dot, BN and
# megakernel as named ("plain" launches no kernel of the port).
ROUTES = {
    "default": ({}, {"v1": 6, "v2": 6, "gram": 3, "plain": 5}),
    "bn_kernel": ({"USE_BN_KERNEL": True},
                  {"v1": 6, "v2": 6, "gram": 3, "plain": 5, "bn": 20}),
    "bn_kernel_grouped": ({"USE_BN_KERNEL": True, "GROUP_BN": True, "GROUP_CONV": True},
                          {"v1": 3, "v2": 2, "gram": 1, "plain": 5, "bn": 4}),
    "catdot": ({"USE_CATDOT": True},
               {"v1": 6, "v2": 3, "catdot": 3, "gram": 3, "plain": 5}),
    "fused": ({"FUSED_BWD": True}, {"v1": 6, "v2": 6, "gram": 3, "plain": 5}),
    "fused_megakernel": ({"FUSED_BWD": True, "MEGAKERNEL": True},
                         {"v1": 2, "gram": 3, "mega": 10, "plain": 5}),
    "stem_kernel": ({"STEM_XLA": False}, {"v1": 7, "v2": 6, "gram": 3, "plain": 4}),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_matches_default_and_pins_launches(resnet18_one, monkeypatch, route):
    model, v, x, y, mask, base = resnet18_one
    flags, want_log = ROUTES[route]
    for name, value in flags.items():
        monkeypatch.setattr(gb, name, value)
    log = []
    if gb.FUSED_BWD or gb.MEGAKERNEL:
        got = gb.batched_grand_scores_fused(model, v, x, y, mask, use_kernels=True,
                                            megakernel=gb.MEGAKERNEL, route_log=log)
    else:
        got = gb.batched_grand_scores(model, v, x, y, mask, use_kernels=True,
                                      route_log=log)
    np.testing.assert_allclose(got.numpy(), base.numpy(), rtol=1e-5)
    assert Counter(r for _, r in log) == want_log
    if route == "catdot":   # stage 2's three unit-stride 16x16x128 convs
        assert {p for p, r in log if r == "catdot"} == {
            "BasicBlock_2.Conv_1", "BasicBlock_3.Conv_0", "BasicBlock_3.Conv_1"}
    if route == "fused_megakernel":   # stages 1-3, unit stride: 4 + 3 + 3
        assert sorted(p for p, r in log if r == "mega") == sorted(
            [f"BasicBlock_{i}.Conv_{j}" for i in (0, 1) for j in (0, 1)]
            + ["BasicBlock_2.Conv_1", "BasicBlock_3.Conv_0", "BasicBlock_3.Conv_1",
               "BasicBlock_4.Conv_1", "BasicBlock_5.Conv_0", "BasicBlock_5.Conv_1"])


class _CountConvBackward(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution_backward.default:
            self.calls += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("megakernel,conv_backwards", [(False, 19), (True, 9)])
def test_megakernel_layers_run_no_conv_backward(resnet18_one, megakernel,
                                                conv_backwards):
    """The megakernel's dx reaches each of its 10 convs' inputs through the tap,
    and those convs' own backward never runs (19 conv backwards: every conv but
    the stem, whose input needs no gradient)."""
    model, v, x, y, mask, base = resnet18_one
    with _CountConvBackward() as counter:
        got = gb.batched_grand_scores_fused(model, v, x, y, mask, use_kernels=True,
                                            megakernel=megakernel)
    assert counter.calls == conv_backwards
    np.testing.assert_allclose(got.numpy(), base.numpy(), rtol=1e-5)


class _BiasConvNet(torch.nn.Module):
    """A 3-channel stem, then two unit-stride 16-channel convs with biases (both
    megakernel layers), BN, a projection-free residual and a linear head."""

    def __init__(self):
        super().__init__()
        self.stem = torch.nn.Conv2d(3, 16, 3, padding=1, bias=False)
        self.bn = torch.nn.BatchNorm2d(16)
        self.conv_a = torch.nn.Conv2d(16, 16, 3, padding=1)
        self.conv_b = torch.nn.Conv2d(16, 16, 3, padding="same")
        self.head = torch.nn.Linear(16, 10)

    def forward(self, x):
        x = torch.relu(self.bn(self.stem(x.permute(0, 3, 1, 2))))
        x = x + self.conv_b(torch.relu(self.conv_a(x)))
        return self.head(x.mean(dim=(2, 3)))


def test_megakernel_route_with_conv_biases_matches_two_phase():
    torch.manual_seed(0)
    model = _BiasConvNet().eval()
    with torch.no_grad():
        model.bn.running_mean.normal_(0, 0.3)
        model.bn.running_var.uniform_(0.5, 1.5)
    v = dict(model.state_dict())
    x = torch.randn(4, 8, 8, 3)
    y, mask = torch.tensor([0, 3, 5, 9]), torch.tensor([1.0, 1.0, 1.0, 0.0])
    base = gb.batched_grand_scores(model, v, x, y, mask, use_kernels=True)
    log = []
    got = gb.batched_grand_scores_fused(model, v, x, y, mask, use_kernels=True,
                                        megakernel=True, route_log=log)
    assert sorted(p for p, r in log if r == "mega") == ["conv_a", "conv_b"]
    np.testing.assert_allclose(got.numpy(), base.numpy(), rtol=1e-5)
    assert got[3] == 0


@pytest.mark.parametrize("toggle", ["GROUP_CONV", "GROUP_BN", "USE_BN_KERNEL"])
def test_fused_route_refuses_grouping_toggles(resnet18_one, monkeypatch, toggle):
    model, v, x, y, mask, _ = resnet18_one
    monkeypatch.setattr(gb, toggle, True)
    with pytest.raises(ValueError, match="incompatible"):
        gb.batched_grand_scores_fused(model, v, x, y, mask, use_kernels=True)


def test_megakernel_requires_the_kernel_route(resnet18_one):
    model, v, x, y, mask, _ = resnet18_one
    with pytest.raises(ValueError, match="MEGAKERNEL"):
        gb.batched_grand_scores_fused(model, v, x, y, mask, use_kernels=False,
                                      megakernel=True)


def test_toggles_share_the_jax_names_and_refuse_typos(monkeypatch):
    for name in TOGGLES:
        assert getattr(gb, name) == getattr(flax_grand_batched, name), name
    monkeypatch.setenv("DDT_GRAND_TEST_FLAG", "maybe")
    with pytest.raises(ValueError, match="DDT_GRAND_TEST_FLAG"):
        gb._toggle("DDT_GRAND_TEST_FLAG", False)
    for value, want in (("1", True), (" ON ", True), ("no", False), ("", False)):
        monkeypatch.setenv("DDT_GRAND_TEST_FLAG", value)
        assert gb._toggle("DDT_GRAND_TEST_FLAG", not want) is want
    monkeypatch.delenv("DDT_GRAND_TEST_FLAG")
    assert gb._toggle("DDT_GRAND_TEST_FLAG", True) is True


@pytest.mark.parametrize("flags,want", [
    ({}, ("two_phase", None)),
    ({"FUSED_BWD": True}, ("fused", False)),
    ({"MEGAKERNEL": True}, ("fused", True)),
])
def test_score_factory_picks_the_route_when_called(monkeypatch, flags, want):
    seen = []
    monkeypatch.setattr(gb, "batched_grand_scores",
                        lambda *a, **k: seen.append(("two_phase", None)))
    monkeypatch.setattr(gb, "batched_grand_scores_fused",
                        lambda *a, megakernel=False, **k: seen.append(("fused",
                                                                        megakernel)))
    for name, value in flags.items():
        monkeypatch.setattr(gb, name, value)
    local = make_local_scores(create_model("tiny_cnn", 10), "grand_batched",
                              use_kernels=True)
    local({}, None, None, None)
    assert seen == [want]


def _engine_cfg(method):
    items = {"data.dataset": "synthetic", "model.arch": "tiny_cnn",
             "train.half_precision": "false", "score.pretrain_epochs": "0",
             "score.batch_size": "8", "score.seeds": "[0,1]", "score.grand_chunk": "3",
             "score.method": method}
    return load_config(None, [f"{k}={v}" for k, v in items.items()])


@pytest.mark.parametrize("method,flags", [
    ("grand_vmap", {}),
    ("grand", {"FUSED_BWD": True, "MEGAKERNEL": True}),
])
def test_score_batch_bitwise_equals_full_scores(monkeypatch, method, flags):
    for name, value in flags.items():
        monkeypatch.setattr(gb, name, value)
    images, labels = _synthetic(13, 10, 2, "train")
    ds = ArrayDataset(images, labels, np.arange(100, 113, dtype=np.int32), 10)
    engine = ServeEngine(_engine_cfg(method), device="cpu")
    engine.register_tenant("syn", ds)
    full = engine.full_scores("syn", method)
    assert full.shape == (13,) and np.isfinite(full).all() and (full > 0).all()
    ids = np.array([112, 100, 105])
    got = engine.score_batch("syn", method, *engine.examples_for("syn", ids))
    assert np.array_equal(got, full[engine.tenant("syn").pos_of(ids)])


@pytest.mark.parametrize("method", ["grand_last_layer", "grand_vmap"])
def test_cli_score_methods(tmp_path, method):
    ckpt = tmp_path / "ckpt"
    assert cli.main(["score", "--config", SMOKE, "--device", "cpu",
                     "score.pretrain_epochs=0", "data.synthetic_size=12",
                     "score.batch_size=8", "score.grand_chunk=4",
                     f"score.method={method}", f"train.checkpoint_dir={ckpt}"]) == 0
    with np.load(f"{ckpt}_scores.npz") as f:
        assert f["scores"].shape == (12,) and np.isfinite(f["scores"]).all()
        assert str(f["method"]) == method
