"""PyTorch port: the GraNd route kernels' plain versions against the Pallas kernels.

The last-layer GraNd, stacked-BatchNorm, cat-dot and megakernel kernels. On the
CPU the port's wrappers run their plain PyTorch versions (the tensors lie on the
CPU); the JAX side runs the real Pallas kernels in interpret mode, at the shapes
``tests/test_pallas.py`` uses. The CUDA kernels run only on a card: those tests
are marked ``cuda`` and skip here (``pytest --noconftest -m cuda
tests/test_torch_route_kernels.py`` on the card; JAX is imported only inside the
comparisons).
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


def _bn_inputs(rng, layers, bl=16, hw=6, ch=32):
    x = rng.normal(size=(layers * bl, hw, hw, ch)).astype(np.float32)
    g = rng.normal(size=(layers * bl, hw, hw, ch)).astype(np.float32)
    means = rng.normal(size=(layers, ch)).astype(np.float32)
    rstds = (np.abs(rng.normal(size=(layers, ch))) + 0.5).astype(np.float32)
    return x, g, np.stack([means, rstds], axis=1)     # stats [L, 2, C]


def test_grand_last_layer_plain_matches_pallas(pallas):
    jnp, pk = pallas
    rng = np.random.default_rng(0)
    b, f, c = 37, 64, 10
    h = rng.normal(size=(b, f)).astype(np.float32)
    w = (rng.normal(size=(f, c)) * 0.3).astype(np.float32)      # Flax [F, C]
    bias = rng.normal(size=c).astype(np.float32)
    y = rng.integers(0, c, b).astype(np.int32)
    m = (rng.random(b) > 0.2).astype(np.float32)
    want = pk.grand_last_layer_pallas(jnp.asarray(h), jnp.asarray(w), jnp.asarray(bias),
                                      jnp.asarray(y), jnp.asarray(m), interpret=True)
    got = K.grand_last_layer(torch.from_numpy(h), torch.from_numpy(w.T.copy()),
                             torch.from_numpy(bias), torch.from_numpy(y),
                             torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert (got.numpy()[m == 0] == 0).all()


@pytest.mark.parametrize("layers,use_scale,use_bias", [
    (1, True, True), (3, True, True), (3, True, False), (3, False, True),
    (1, False, False),
])
def test_bn_plain_matches_pallas(pallas, layers, use_scale, use_bias):
    jnp, pk = pallas
    rng = np.random.default_rng(4)
    bl = 16
    x, g, stats = _bn_inputs(rng, layers, bl)
    slab = np.pad(stats, ((0, 0), (0, 6), (0, 0)))    # the TPU's 8-row stats slab
    want = pk.bn_grad_norm_sq_pallas(jnp.asarray(x), jnp.asarray(g), jnp.asarray(slab),
                                     bl, use_scale=use_scale, use_bias=use_bias,
                                     interpret=True)
    xs = [torch.from_numpy(x[i * bl:(i + 1) * bl]) for i in range(layers)]
    gs = [torch.from_numpy(g[i * bl:(i + 1) * bl]) for i in range(layers)]
    got = K.bn_grad_norm_sq(xs, gs, torch.from_numpy(stats), use_scale=use_scale,
                            use_bias=use_bias)
    assert got.shape == (layers * bl,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


def test_catdot_plain_matches_pallas(pallas):
    jnp, pk = pallas
    rng = np.random.default_rng(3)
    h, c, k = 16, 128, 128
    x = rng.normal(size=(2, h, h, c)).astype(np.float32)
    g = rng.normal(size=(2, h, h, k)).astype(np.float32)
    want = pk.conv_grad_norm_sq_pallas(jnp.asarray(x), jnp.asarray(g), (3, 3), (1, 1),
                                       PAD1, interpret=True, catdot=True)
    got = K.conv_grad_norm_sq_catdot(torch.from_numpy(x), torch.from_numpy(g), (3, 3),
                                     PAD1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    direct = K.conv_grad_norm_sq_plain(torch.from_numpy(x), torch.from_numpy(g), (3, 3),
                                       (1, 1), PAD1)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), rtol=1e-5)


@pytest.mark.parametrize("c,k,bias", [
    (16, 16, True),     # stage conv
    (64, 64, True),     # the TPU's two-examples-per-dot (packed) case
])
def test_megakernel_plain_matches_pallas(pallas, c, k, bias):
    jnp, pk = pallas
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 8, 8, c)).astype(np.float32)
    g = rng.normal(size=(4, 8, 8, k)).astype(np.float32)
    w = (rng.normal(size=(3, 3, c, k)) * 0.1).astype(np.float32)   # Flax [kh, kw, C, K]
    want_dx, want_ns = pk.conv_bwd_grad_norm_sq_pallas(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(w), (3, 3), PAD1, use_bias=bias,
        interpret=True)
    dx, ns = K.conv_bwd_grad_norm_sq(torch.from_numpy(x), torch.from_numpy(g),
                                     torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                                     (3, 3), PAD1, use_bias=bias)
    assert dx.shape == x.shape and dx.dtype == torch.float32
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ns.numpy(), np.asarray(want_ns), rtol=1e-5, atol=1e-3)


def test_megakernel_plain_asymmetric_padding_is_the_conv_backward():
    """dx is the conv's input gradient for any explicit padding (autograd of
    the same conv as the reference)."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 5, 6, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(12, 8, 3, 2)).astype(np.float32))
    pad = ((0, 2), (1, 0))
    xn = x.permute(0, 3, 1, 2).requires_grad_(True)
    y = torch.nn.functional.conv2d(torch.nn.functional.pad(xn, (1, 0, 0, 2)), w)
    g = torch.from_numpy(rng.normal(size=y.shape).astype(np.float32))
    (want,) = torch.autograd.grad(y, xn, g)
    dx, _ = K.conv_bwd_grad_norm_sq(x, g.permute(0, 2, 3, 1).contiguous(), w, (3, 2), pad)
    np.testing.assert_allclose(dx.numpy(), want.permute(0, 2, 3, 1).numpy(), rtol=1e-5,
                               atol=1e-5)


def test_catdot_plain_equals_direct_plain_off_square():
    """The cat-dot form computes the direct form's quantity for asymmetric
    padding and a non-square kernel too (Wp = Wo + kw − 1)."""
    rng = np.random.default_rng(2)
    pad = ((0, 2), (2, 0))
    x = torch.from_numpy(rng.normal(size=(2, 10, 11, 128)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, 10, 12, 128)).astype(np.float32))
    assert K.conv_grad_norm_catdot_eligible(x.shape, g.shape, (3, 2), (1, 1), pad)
    got = K.conv_grad_norm_sq_catdot(x, g, (3, 2), pad)
    want = K.conv_grad_norm_sq_plain(x, g, (3, 2), (1, 1), pad)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5)


def test_hopper_gates():
    """Cat-dot keeps the algorithmic gates and, to re-measure, C % 128 = K % 128
    = 0; the megakernel takes unit stride; the last-layer kernel needs one
    warp's (F + C) floats within a block's shared memory; the BN kernel 4-D
    activations."""
    cat = K.conv_grad_norm_catdot_eligible
    assert cat((8, 16, 16, 128), (8, 16, 16, 128), (3, 3), (1, 1), PAD1)
    assert not cat((8, 32, 32, 64), (8, 32, 32, 64), (3, 3), (1, 1), PAD1)   # c % 128
    assert not cat((8, 4, 4, 128), (8, 4, 4, 128), (3, 3), (1, 1), PAD1)     # Ho*Wp < 128
    assert not cat((8, 16, 16, 128), (8, 16, 16, 128), (1, 1), (1, 1), PAD0)  # 1x1
    assert not cat((8, 16, 16, 128), (8, 8, 8, 128), (3, 3), (2, 2), PAD1)   # strided
    mega = K.conv_bwd_grad_norm_eligible
    assert mega((8, 32, 32, 64), (8, 32, 32, 64), (3, 3), (1, 1))
    assert not mega((8, 16, 16, 64), (8, 8, 8, 128), (3, 3), (2, 2))
    assert K.grand_last_layer_eligible(2048, 1000)
    assert not K.grand_last_layer_eligible(60000, 10)
    assert K.bn_grad_norm_eligible((8, 6, 6, 32))
    assert not K.bn_grad_norm_eligible((8, 32))


def test_wrappers_refuse_bad_inputs():
    with pytest.raises(ValueError, match="eligible"):
        K.conv_grad_norm_sq_catdot(torch.zeros(2, 8, 8, 64), torch.zeros(2, 8, 8, 64),
                                   (3, 3), PAD1)
    with pytest.raises(ValueError, match="weight"):
        K.conv_bwd_grad_norm_sq(torch.zeros(2, 8, 8, 16), torch.zeros(2, 8, 8, 16),
                                torch.zeros(16, 16, 1, 1), (3, 3), PAD1)
    with pytest.raises(ValueError, match="geometry"):
        K.conv_bwd_grad_norm_sq(torch.zeros(2, 8, 8, 16), torch.zeros(2, 4, 4, 16),
                                torch.zeros(16, 16, 3, 3), (3, 3), PAD1)
    with pytest.raises(ValueError, match="stats"):
        K.bn_grad_norm_sq([torch.zeros(2, 4, 4, 8)], [torch.zeros(2, 4, 4, 8)],
                          torch.zeros(2, 2, 8))
    with pytest.raises(ValueError, match="share one shape"):
        K.bn_grad_norm_sq([torch.zeros(2, 4, 4, 8), torch.zeros(3, 4, 4, 8)],
                          [torch.zeros(2, 4, 4, 8), torch.zeros(3, 4, 4, 8)],
                          torch.zeros(2, 2, 8))
    with pytest.raises(ValueError, match="want features"):
        K.grand_last_layer(torch.zeros(3, 8), torch.zeros(10, 7), torch.zeros(10),
                           torch.zeros(3, dtype=torch.long), torch.ones(3))


def test_plain_versions_do_not_count_launches():
    K.reset_launch_counts()
    x = torch.randn(2, 16, 16, 128)
    K.conv_grad_norm_sq_catdot(x, torch.randn(2, 16, 16, 128), (3, 3), PAD1)
    K.conv_bwd_grad_norm_sq(x[..., :8], torch.randn(2, 16, 16, 8),
                            torch.randn(8, 8, 3, 3), (3, 3), PAD1)
    K.bn_grad_norm_sq([x], [x], torch.ones(1, 2, 128))
    K.grand_last_layer(torch.randn(2, 8), torch.randn(3, 8), torch.zeros(3),
                       torch.tensor([0, 2]), torch.ones(2))
    assert set(K.launch_counts().values()) == {0}


# ----------------------------------------------------------- card-only tests


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is compiled and run only there")
    from data_diet_distributed_tpu_torch.device import set_parity_mode
    set_parity_mode(True)
    return torch.device("cuda")


def _rtol(dtype):
    return 1e-4 if dtype == torch.float32 else 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("b,f,c", [(37, 64, 10), (300, 2048, 1000)])
def test_grand_last_layer_kernel_matches_plain_on_card(cuda_device, b, f, c):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    h = torch.randn((b, f), generator=gen, device=cuda_device)
    w = torch.randn((c, f), generator=gen, device=cuda_device) * f ** -0.5
    bias = torch.randn(c, generator=gen, device=cuda_device)
    y = torch.randint(0, c, (b,), generator=gen, device=cuda_device)
    m = (torch.rand(b, generator=gen, device=cuda_device) > 0.1).float()
    before = K.launch_counts()["grand_last_layer"]
    got = K.grand_last_layer(h, w, bias, y, m)
    torch.cuda.synchronize()
    assert K.launch_counts()["grand_last_layer"] == before + 1
    np.testing.assert_allclose(got.cpu().numpy(),
                               K.grand_last_layer_plain(h, w, bias, y, m).cpu().numpy(),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layers,hw,ch,use_scale,use_bias", [
    (1, 6, 32, True, True), (3, 7, 100, True, False), (2, 4, 512, False, True),
])
def test_bn_kernel_matches_plain_on_card(cuda_device, dtype, layers, hw, ch, use_scale,
                                         use_bias):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    xs = [torch.randn((5, hw, hw, ch), generator=gen, device=cuda_device).to(dtype)
          for _ in range(layers)]
    gs = [torch.randn((5, hw, hw, ch), generator=gen, device=cuda_device).to(dtype)
          for _ in range(layers)]
    stats = torch.rand((layers, 2, ch), generator=gen, device=cuda_device) + 0.5
    got = K.bn_grad_norm_sq(xs, gs, stats, use_scale, use_bias)
    want = K.bn_grad_norm_sq_plain(xs, gs, stats, use_scale, use_bias)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=_rtol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,c,k,pad", [(16, 128, 128, PAD1), (12, 128, 256, ((0, 2), (2, 0)))])
def test_catdot_kernel_matches_plain_on_card(cuda_device, dtype, h, c, k, pad):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((3, h, h, c), generator=gen, device=cuda_device).to(dtype)
    g = torch.randn((3, h, h, k), generator=gen, device=cuda_device).to(dtype)
    got = K.conv_grad_norm_sq_catdot(x, g, (3, 3), pad)
    want = K.conv_grad_norm_sq_plain(x, g, (3, 3), (1, 1), pad)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=_rtol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,c,k,ks,pad,bias", [
    (8, 16, 16, (3, 3), PAD1, True),
    (9, 72, 136, (3, 3), PAD1, False),
    (7, 64, 48, (3, 2), ((0, 2), (1, 0)), True),
])
def test_megakernel_matches_plain_on_card(cuda_device, dtype, h, c, k, ks, pad, bias):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    ho = h + pad[0][0] + pad[0][1] - ks[0] + 1
    wo = h + pad[1][0] + pad[1][1] - ks[1] + 1
    x = torch.randn((3, h, h, c), generator=gen, device=cuda_device).to(dtype)
    g = torch.randn((3, ho, wo, k), generator=gen, device=cuda_device).to(dtype)
    w = torch.randn((k, c, *ks), generator=gen, device=cuda_device) * 0.1
    dx, ns = K.conv_bwd_grad_norm_sq(x, g, w, ks, pad, use_bias=bias)
    want_dx, want_ns = K.conv_bwd_grad_norm_sq_plain(x, g, w, ks, pad, use_bias=bias)
    torch.cuda.synchronize()
    assert dx.dtype == dtype
    np.testing.assert_allclose(ns.cpu().numpy(), want_ns.cpu().numpy(), rtol=_rtol(dtype))
    # bf16 dx: both sides round one fp32 sum to bf16, so they may differ by one
    # bf16 ulp (2^-8 relative) where the sums straddle a rounding boundary.
    tol = 1e-4 if dtype == torch.float32 else 2 ** -7
    err = (dx.float() - want_dx.float()).abs()
    assert float((err - tol * want_dx.float().abs()).max()) <= 1e-4
