"""PyTorch port: batched exact GraNd against the JAX package's, routes and refusals.

The JAX side runs ``batched_grand_scores(use_pallas=False)``; the port runs its
kernel routes, which on CPU tensors compute the kernels' plain versions. Every
BatchNorm is randomized first (at init the closing BN scale is zero, which
would zero the cotangent of half the convs).
"""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from data_diet_distributed_tpu.ops.grand_batched import \
    batched_grand_scores as flax_batched_grand_scores
from data_diet_distributed_tpu_torch.models import create_model
from data_diet_distributed_tpu_torch.ops.grand_batched import batched_grand_scores
from data_diet_distributed_tpu_torch.weights import init_variables
from test_torch_models import ported


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread for this file's small ops: the test workers share
    the machine's cores, and oversubscribed thread pools make each op wait."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name,batch", [("tiny", 4), ("narrow", 4), ("resnet18", 2),
                                        ("narrow_bottleneck", 4)])
def test_batched_grand_matches_jax(name, batch):
    fm, tree, tm, variables, x, y = ported(name, batch, seed=1)
    mask = np.ones(batch, np.float32)
    mask[-1] = 0.0
    want = np.asarray(flax_batched_grand_scores(
        fm, tree, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask), use_pallas=False))
    log = []
    got = batched_grand_scores(tm, variables, torch.from_numpy(x), torch.from_numpy(y),
                               torch.from_numpy(mask), use_kernels=True, route_log=log)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-5)
    plain = batched_grand_scores(tm, variables, torch.from_numpy(x),
                                 torch.from_numpy(y), torch.from_numpy(mask))
    np.testing.assert_allclose(plain.numpy(), want, rtol=2e-4, atol=1e-5)
    if name == "resnet18":
        # The kernel table: 6 layers on v1, 6 on v2, 3 on Gram, 5 plain.
        routes = dict(log)
        assert Counter(routes.values()) == {"v1": 6, "v2": 6, "gram": 3, "plain": 5}
        assert routes["stem_conv"] == "plain"
        assert all(routes[f"BasicBlock_{i}.Conv_{j}"] == "v1"
                   for i in (0, 1) for j in (0, 1))
        assert routes["BasicBlock_2.Conv_0"] == routes["BasicBlock_2.proj_conv"] == "v1"
        assert all(routes[p] == "v2" for p in (
            "BasicBlock_2.Conv_1", "BasicBlock_3.Conv_0", "BasicBlock_3.Conv_1",
            "BasicBlock_4.Conv_1", "BasicBlock_5.Conv_0", "BasicBlock_5.Conv_1"))
        assert all(routes[p] == "gram" for p in (
            "BasicBlock_6.Conv_1", "BasicBlock_7.Conv_0", "BasicBlock_7.Conv_1"))
        assert all(routes[f"BasicBlock_{i}.{c}"] == "plain"
                   for i in (4, 6) for c in ("Conv_0", "proj_conv"))


def test_route_is_the_same_in_bf16():
    model = create_model("resnet18", 10, half_precision=True)
    v = init_variables("resnet18", 0, "cpu")
    log = []
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 32, 32, 3)).astype(np.float32))
    out = batched_grand_scores(model, v, x, torch.tensor([1, 2]), torch.ones(2),
                               use_kernels=True, route_log=log)
    assert torch.isfinite(out).all()
    assert Counter(r for _, r in log) == {"v1": 6, "v2": 6, "gram": 3, "plain": 5}


class _Wrap(nn.Module):
    def __init__(self, *layers):
        super().__init__()
        self.body = nn.Sequential(*layers)
        self.head = nn.Linear(4, 3)

    def forward(self, x):
        return self.head(self.body(x.permute(0, 3, 1, 2)).mean(dim=(2, 3)))


def _run(model):
    model.eval()
    v = dict(model.state_dict(keep_vars=True))   # tied weights stay one tensor
    x = torch.randn(2, 6, 6, 4)
    return batched_grand_scores(model, v, x, torch.tensor([0, 1]), torch.ones(2))


@pytest.mark.parametrize("layer,err", [
    (nn.Conv2d(4, 4, 3, padding=1, groups=2), NotImplementedError),
    (nn.Conv2d(4, 4, 3, padding=2, dilation=2), NotImplementedError),
    (nn.Conv2d(4, 4, 3, padding=1, padding_mode="circular"), NotImplementedError),
    (nn.GroupNorm(2, 4), NotImplementedError),          # uncovered parameters
])
def test_refusals(layer, err):
    with pytest.raises(err):
        _run(_Wrap(layer))


def test_train_mode_batchnorm_refused():
    model = _Wrap(nn.BatchNorm2d(4))
    v = dict(model.state_dict())
    model.train()
    with pytest.raises(ValueError, match="eval-mode BatchNorm"):
        batched_grand_scores(model, v, torch.randn(2, 6, 6, 4), torch.tensor([0, 1]),
                             torch.ones(2))


def test_shared_module_refused():
    conv = nn.Conv2d(4, 4, 3, padding=1)
    with pytest.raises(NotImplementedError, match="more than once"):
        _run(_Wrap(conv, conv))


def test_same_padding_string_and_bias():
    """``padding="same"`` resolves with XLA's SAME arithmetic; conv biases add
    their term on every route."""
    model = _Wrap(nn.Conv2d(4, 4, 3, padding="same"), nn.Conv2d(4, 4, 1))
    model.eval()
    v = dict(model.state_dict())
    x = torch.randn(3, 6, 6, 4)
    y = torch.tensor([0, 1, 2])
    got = batched_grand_scores(model, v, x, y, torch.ones(3), use_kernels=True)
    want = []
    for i in range(3):   # per-example autograd reference
        model.zero_grad()
        loss = nn.functional.cross_entropy(model(x[i:i + 1]), y[i:i + 1])
        loss.backward()
        want.append(float(sum((p.grad ** 2).sum() for p in model.parameters())) ** 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
