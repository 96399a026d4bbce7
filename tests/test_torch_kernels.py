"""PyTorch port: the hand-written kernels' plain versions against the Pallas kernels.

On the CPU the port's kernel wrappers run their plain PyTorch versions (the
tensors lie on the CPU); the JAX side runs the real Pallas kernels in interpret
mode, at the shapes ``tests/test_pallas.py`` uses. The CUDA kernels themselves
run only on a card: those tests are marked ``cuda`` and skip here. JAX is
imported inside the comparisons, so the card-only tests also run on a machine
without it (``pytest --noconftest -m cuda tests/test_torch_kernels.py``).
"""

import numpy as np
import pytest
import torch

from data_diet_distributed_tpu_torch.ops import kernels as K

PAD1 = ((1, 1), (1, 1))
PAD0 = ((0, 0), (0, 0))


@pytest.fixture(scope="module")
def pallas():
    """(jax.numpy, the JAX package's Pallas kernels)."""
    jnp = pytest.importorskip("jax.numpy")
    from data_diet_distributed_tpu.ops import pallas_kernels
    return jnp, pallas_kernels


def _pair(rng, b, h, c, ho, k):
    x = rng.normal(size=(b, h, h, c)).astype(np.float32)
    g = rng.normal(size=(b, ho, ho, k)).astype(np.float32)
    return x, g


@pytest.mark.parametrize("h,c,k,ks,st,pad", [
    (8, 16, 16, (3, 3), (1, 1), PAD1),    # stage conv
    (8, 16, 32, (3, 3), (2, 2), PAD1),    # strided stage entry
    (8, 16, 32, (1, 1), (2, 2), PAD0),    # projection shortcut
])
def test_direct_v1_plain_matches_pallas(pallas, h, c, k, ks, st, pad):
    jnp, pk = pallas
    rng = np.random.default_rng(0)
    ho = (h + pad[0][0] + pad[0][1] - ks[0]) // st[0] + 1
    x, g = _pair(rng, 10, h, c, ho, k)
    want = pk.conv_grad_norm_sq_pallas(jnp.asarray(x), jnp.asarray(g), ks, st, pad,
                                       interpret=True)
    got = K.conv_grad_norm_sq(torch.from_numpy(x), torch.from_numpy(g), ks, st, pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("h,c,k,bias", [
    (16, 128, 128, False),   # stage-2 geometry
    (8, 256, 256, True),     # stage-3 geometry + bias term
])
def test_direct_v2_plain_matches_pallas(pallas, h, c, k, bias):
    jnp, pk = pallas
    rng = np.random.default_rng(0)
    x, g = _pair(rng, 10, h, c, h, k)
    want = pk.conv_grad_norm_sq_v2(jnp.asarray(x), jnp.asarray(g), (3, 3), PAD1,
                                   use_bias=bias, interpret=True)
    got = K.conv_grad_norm_sq_v2(torch.from_numpy(x), torch.from_numpy(g), (3, 3),
                                 PAD1, use_bias=bias)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("h,c,k,bias", [
    (8, 128, 128, False),    # small-S wide-channel (Gram regime)
    (4, 256, 256, True),     # stage-4-like + bias term
])
def test_gram_plain_matches_pallas(pallas, h, c, k, bias):
    jnp, pk = pallas
    rng = np.random.default_rng(0)
    x, g = _pair(rng, 10, h, c, h, k)
    want = pk.conv_grad_norm_sq_gram(jnp.asarray(x), jnp.asarray(g), (3, 3), PAD1,
                                     use_bias=bias, interpret=True)
    got = K.conv_grad_norm_sq_gram(torch.from_numpy(x), torch.from_numpy(g), (3, 3),
                                   PAD1, use_bias=bias)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-2)


@pytest.mark.parametrize("b,c", [(37, 10), (256, 100)])
def test_el2n_plain_matches_pallas(pallas, b, c):
    jnp, pk = pallas
    rng = np.random.default_rng(0)
    z = (rng.normal(size=(b, c)) * 3).astype(np.float32)
    y = rng.integers(0, c, b).astype(np.int32)
    m = (rng.random(b) > 0.1).astype(np.float32)   # partial mask
    want = pk.el2n_pallas(jnp.asarray(z), jnp.asarray(y), jnp.asarray(m),
                          interpret=True)
    got = K.el2n(torch.from_numpy(z), torch.from_numpy(y), torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_gram_plain_equals_direct_plain():
    """The two forms compute one quantity (bias term included)."""
    rng = np.random.default_rng(1)
    x, g = (torch.from_numpy(a) for a in _pair(rng, 4, 4, 24, 4, 40))
    direct = K.conv_grad_norm_sq_plain(x, g, (3, 3), (1, 1), PAD1, use_bias=True)
    gram = K.conv_grad_norm_sq_gram_plain(x, g, (3, 3), PAD1, use_bias=True)
    np.testing.assert_allclose(gram.numpy(), direct.numpy(), rtol=1e-5)


def test_hopper_gates():
    """v2: unit stride and S <= 256 (cotangent tile resident in shared memory);
    Gram: unit stride and both Grams within one block's shared memory."""
    assert K.conv_grad_norm_v2_eligible((8, 16, 16, 128), (8, 16, 16, 128), (3, 3),
                                        (1, 1), PAD1)
    assert not K.conv_grad_norm_v2_eligible((8, 32, 32, 64), (8, 32, 32, 64), (3, 3),
                                            (1, 1), PAD1)          # S = 1024
    assert not K.conv_grad_norm_v2_eligible((8, 16, 16, 128), (8, 8, 8, 128), (3, 3),
                                            (2, 2), PAD1)          # strided
    assert K.conv_grad_norm_gram_eligible((8, 4, 4, 512), (8, 4, 4, 512), (3, 3),
                                          (1, 1), PAD1)
    assert not K.conv_grad_norm_gram_eligible((8, 8, 8, 256), (8, 4, 4, 512), (3, 3),
                                              (2, 2), PAD1)        # strided
    assert not K.conv_grad_norm_gram_eligible((8, 16, 16, 128), (8, 16, 16, 128),
                                              (3, 3), (1, 1), PAD1)  # Grams > 227 KB
    assert K.conv_grad_norm_direct_fits((8, 32, 32, 64), (8, 16, 16, 128), (3, 3),
                                        (2, 2))


def test_wrappers_refuse_bad_inputs():
    x = torch.zeros(2, 8, 8, 16)
    with pytest.raises(TypeError):
        K.conv_grad_norm_sq(x, torch.zeros(2, 8, 8, 16, dtype=torch.float64),
                            (3, 3), (1, 1), PAD1)
    with pytest.raises(ValueError, match="geometry"):
        K.conv_grad_norm_sq(x, torch.zeros(2, 4, 4, 16), (3, 3), (1, 1), PAD1)
    with pytest.raises(ValueError, match="eligible"):
        K.conv_grad_norm_sq_v2(torch.zeros(2, 32, 32, 16), torch.zeros(2, 32, 32, 16),
                               (3, 3), PAD1)
    with pytest.raises(ValueError, match="not supported"):
        K.el2n(torch.zeros(2, 3, device="meta"), torch.zeros(2, dtype=torch.long,
                                                             device="meta"),
               torch.zeros(2, device="meta"))


def test_plain_versions_do_not_count_launches():
    K.reset_launch_counts()
    x = torch.randn(2, 4, 4, 8)
    K.conv_grad_norm_sq(x, torch.randn(2, 4, 4, 8), (3, 3), (1, 1), PAD1)
    K.el2n(torch.randn(2, 3), torch.tensor([0, 2]), torch.ones(2))
    assert K.launch_counts() == {name: 0 for name in (
        "conv_grad_norm_direct", "conv_grad_norm_gram", "el2n", "grand_last_layer",
        "bn_grad_norm", "conv_grad_norm_catdot", "conv_bwd_grad_norm")}


# ----------------------------------------------------------- card-only tests


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is compiled and run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("entry,h,c,k,ks,st,pad,bias", [
    ("v1", 8, 16, 16, (3, 3), (1, 1), PAD1, False),
    ("v1", 9, 48, 80, (3, 3), (2, 2), PAD1, False),
    ("v1", 8, 16, 32, (1, 1), (2, 2), PAD0, False),
    ("v2", 7, 72, 136, (3, 3), (1, 1), PAD1, True),
    ("gram", 4, 100, 70, (3, 3), (1, 1), PAD1, True),
    ("gram", 5, 64, 64, (3, 3), (1, 1), ((0, 2), (2, 0)), False),
])
def test_kernel_matches_plain_on_card(cuda_device, dtype, entry, h, c, k, ks, st,
                                      pad, bias):
    from data_diet_distributed_tpu_torch.device import set_parity_mode
    set_parity_mode(True)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    ho = (h + pad[0][0] + pad[0][1] - ks[0]) // st[0] + 1
    x = torch.randn((6, h, h, c), generator=gen, device=cuda_device).to(dtype)
    g = torch.randn((6, ho, ho, k), generator=gen, device=cuda_device).to(dtype)
    before = K.launch_counts()
    if entry == "v1":
        got = K.conv_grad_norm_sq(x, g, ks, st, pad)
        want = K.conv_grad_norm_sq_plain(x, g, ks, st, pad)
        name = "conv_grad_norm_direct"
    elif entry == "v2":
        got = K.conv_grad_norm_sq_v2(x, g, ks, pad, use_bias=bias)
        want = K.conv_grad_norm_sq_plain(x, g, ks, st, pad, use_bias=bias)
        name = "conv_grad_norm_direct"
    else:
        got = K.conv_grad_norm_sq_gram(x, g, ks, pad, use_bias=bias)
        want = K.conv_grad_norm_sq_gram_plain(x, g, ks, pad, use_bias=bias)
        name = "conv_grad_norm_gram"
    torch.cuda.synchronize()
    assert K.launch_counts()[name] == before[name] + 1
    rtol = 1e-4 if dtype == torch.float32 else 1e-3
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,c", [(37, 10), (300, 1000)])
def test_el2n_kernel_matches_plain_on_card(cuda_device, b, c):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    z = torch.randn((b, c), generator=gen, device=cuda_device) * 3
    y = torch.randint(0, c, (b,), generator=gen, device=cuda_device)
    m = (torch.rand(b, generator=gen, device=cuda_device) > 0.1).float()
    got = K.el2n(z, y, m)
    want = K.el2n_plain(z, y, m)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5,
                               atol=1e-6)
