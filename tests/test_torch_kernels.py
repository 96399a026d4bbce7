"""PyTorch port: the hand-written kernels' plain versions against the Pallas kernels.

On the CPU the port's kernel wrappers run their plain PyTorch versions (the
tensors lie on the CPU); the JAX side runs the real Pallas kernels in interpret
mode, at the shapes ``tests/test_pallas.py`` uses. The CUDA kernels themselves
run only on a card: those tests are marked ``cuda`` and skip here. JAX is
imported inside the comparisons, so the card-only tests also run on a machine
without it (``pytest --noconftest -m cuda tests/test_torch_kernels.py``).
"""

import os
import re

import numpy as np
import pytest
import torch

from data_diet_distributed_tpu_torch.ops import build
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


def _both_sides(jnp, x, g, dtype):
    """The same numpy inputs as JAX and as PyTorch arrays of ``dtype`` (both
    round float32 to bfloat16 to nearest even)."""
    jx, jg = jnp.asarray(x), jnp.asarray(g)
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    if dtype == "bfloat16":
        jx, jg = jx.astype(jnp.bfloat16), jg.astype(jnp.bfloat16)
        tx, tg = tx.to(torch.bfloat16), tg.to(torch.bfloat16)
    return jx, jg, tx, tg


# bfloat16 cases pin the semantics of the kernel's tensor-core mode: bf16 inputs,
# exact products and float32 sums on both sides, so float32's tolerance holds.
@pytest.mark.parametrize("h,c,k,ks,st,pad,dtype", [
    pytest.param(8, 16, 16, (3, 3), (1, 1), PAD1, "float32",
                 id="8-16-16-ks0-st0-pad0"),                   # stage conv
    pytest.param(8, 16, 32, (3, 3), (2, 2), PAD1, "float32",
                 id="8-16-32-ks1-st1-pad1"),                   # strided stage entry
    pytest.param(8, 16, 32, (1, 1), (2, 2), PAD0, "float32",
                 id="8-16-32-ks2-st2-pad2"),                   # projection shortcut
    (8, 16, 16, (3, 3), (1, 1), PAD1, "bfloat16"),
    (8, 16, 32, (3, 3), (2, 2), PAD1, "bfloat16"),
    (9, 48, 80, (3, 3), (2, 2), PAD1, "bfloat16"),             # ragged, strided
    (8, 16, 32, (1, 1), (2, 2), PAD0, "bfloat16"),
    (7, 72, 136, (3, 3), (1, 1), PAD1, "bfloat16"),            # ragged C and K
    (10, 20, 24, (3, 3), (1, 1), ((0, 2), (2, 0)), "bfloat16"),  # C % 8 != 0
])
def test_direct_v1_plain_matches_pallas(pallas, h, c, k, ks, st, pad, dtype):
    jnp, pk = pallas
    rng = np.random.default_rng(0)
    ho = (h + pad[0][0] + pad[0][1] - ks[0]) // st[0] + 1
    jx, jg, tx, tg = _both_sides(jnp, *_pair(rng, 10, h, c, ho, k), dtype)
    want = pk.conv_grad_norm_sq_pallas(jx, jg, ks, st, pad, interpret=True)
    got = K.conv_grad_norm_sq(tx, tg, ks, st, pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("h,c,k,bias,dtype", [
    pytest.param(16, 128, 128, False, "float32", id="16-128-128-False"),  # stage 2
    pytest.param(8, 256, 256, True, "float32", id="8-256-256-True"),  # stage 3 + bias
    (16, 128, 128, False, "bfloat16"),
    (8, 256, 256, True, "bfloat16"),
])
def test_direct_v2_plain_matches_pallas(pallas, h, c, k, bias, dtype):
    jnp, pk = pallas
    rng = np.random.default_rng(0)
    jx, jg, tx, tg = _both_sides(jnp, *_pair(rng, 10, h, c, h, k), dtype)
    want = pk.conv_grad_norm_sq_v2(jx, jg, (3, 3), PAD1, use_bias=bias, interpret=True)
    got = K.conv_grad_norm_sq_v2(tx, tg, (3, 3), PAD1, use_bias=bias)
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


def test_csrc_includes_are_build_headers():
    """Every quoted include of a kernel source or header names a header that
    ``build.HEADERS`` lists (so the build hash covers it), and each exists."""
    csrc = os.path.join(os.path.dirname(build.__file__), "csrc")
    names = sorted(f for f in os.listdir(csrc) if f.endswith((".cu", ".cuh")))
    assert set(build.SOURCES.values()) | set(build.HEADERS) == set(names)
    for name in names:
        with open(os.path.join(csrc, name)) as fh:
            for inc in re.findall(r'^#include "([^"]+)"', fh.read(), flags=re.M):
                assert inc in build.HEADERS, f"{name} includes {inc}"


def test_mma_constants_match_the_header():
    """The Python plan's constants are conv_norm_mma.cuh's."""
    path = os.path.join(os.path.dirname(build.__file__), "csrc", "conv_norm_mma.cuh")
    with open(path) as fh:
        consts: dict = {}
        for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", fh.read()):
            consts[name] = eval(expr, {}, dict(consts))
    assert consts == {
        "kMmaTile": K.DIRECT_TILE, "kMmaThreads": 128,
        "kMmaOffsets": K.DIRECT_MMA_OFFSETS, "kMmaGroups": K.DIRECT_MMA_GROUPS,
        "kMmaChunk": K.DIRECT_MMA_CHUNK,
        "kMmaMaxCols": K.DIRECT_MMA_MAX_COLS, "kMmaStages": K.DIRECT_MMA_STAGES,
        "kRowElems": K.DIRECT_MMA_ROW_BYTES // 2, "kRowBytes": K.DIRECT_MMA_ROW_BYTES,
        "kMmaMaxSmem": K.DIRECT_MMA_MAX_SMEM}
    # The megakernel's dx-role constants (conv_bwd_grad_norm.cu), mirrored by
    # mega_dx_plan.
    path = os.path.join(os.path.dirname(build.__file__), "csrc", "conv_bwd_grad_norm.cu")
    with open(path) as fh:
        dx = {name: eval(expr, {}, {}) for name, expr in
              re.findall(r"constexpr int (kDx\w+) = ([^;]+);", fh.read())}
    assert dx == {"kDxK": K.MEGA_DX_K, "kDxRowElems": K.MEGA_DX_ROW_BYTES // 2,
                  "kDxMaxCols": K.MEGA_DX_MAX_COLS, "kDxMaxSmem": K.MEGA_DX_MAX_SMEM}


def _mma_tiling_norm(x, g, ks, st, pad, plan):
    """The tensor-core mode's tiling in numpy (float64): each chunk's input
    band and cotangent rows as the kernel stages them (zero outside the input,
    past the map and past the chunk), and each offset's window read from the
    band at (rr·out_dy + oy, qq·out_dx + ox), as the kernel's ldmatrix
    addresses do."""
    (kh, kw), (sy, sx) = ks, st
    (pt, _), (pl, _) = pad
    b, h, w, c = x.shape
    _, ho, wo, k = g.shape
    rows, cols = plan["rows"], plan["cols"]
    m = np.zeros((b, kh * kw, c, k))
    seen = np.zeros((ho, wo), dtype=int)
    for ci in range(plan["chunks_r"] * plan["chunks_q"]):
        r0, q0 = ci // plan["chunks_q"] * rows, ci % plan["chunks_q"] * cols
        nr, nq = min(rows, ho - r0), min(cols, wo - q0)
        band = np.zeros((b, plan["band_h"], plan["band_w"], c))
        for by in range(plan["band_h"]):
            for bx in range(plan["band_w"]):
                iy = r0 * sy - pt + by * plan["in_dy"]
                ix = q0 * sx - pl + bx * plan["in_dx"]
                if 0 <= iy < h and 0 <= ix < w:
                    band[:, by, bx] = x[:, iy, ix]
        steps = -(-nr * cols // 16)
        assert steps * 16 <= plan["g_rows"]
        s = np.arange(steps * 16)
        rr, qq = s // cols, s % cols
        ok = (rr < nr) & (qq < nq)
        rr, qq = rr[ok], qq[ok]
        seen[r0 + rr, q0 + qq] += 1
        gch = g[:, r0 + rr, q0 + qq]                                   # [b, n, k]
        for o in range(kh * kw):
            oy, ox = divmod(o, kw)
            window = band[:, rr * plan["out_dy"] + oy, qq * plan["out_dx"] + ox]
            m[:, o] += np.einsum("bnc,bnk->bck", window, gch)
    assert (seen == 1).all()            # the chunks cover the map once
    return (m * m).sum(axis=(1, 2, 3))


# ResNet-18's five direct geometries at CIFAR-10 size, then ragged ones.
@pytest.mark.parametrize("h,ho,ks,st,pad,want", [
    (32, 32, (3, 3), (1, 1), PAD1, (4, 32, 95760)),
    (32, 16, (3, 3), (2, 2), PAD1, (4, 16, 104112)),
    (32, 16, (1, 1), (2, 2), PAD0, (8, 16, 73872)),
    (16, 16, (3, 3), (1, 1), PAD1, (8, 16, 88848)),
    (8, 8, (3, 3), (1, 1), PAD1, (8, 8, 47376)),
    (12, 12, (3, 3), (1, 1), PAD1, None),
    (9, 5, (3, 3), (2, 2), PAD1, None),
    (10, 10, (3, 3), (1, 1), ((0, 2), (2, 0)), None),
    (40, 40, (3, 3), (1, 1), PAD1, None),                       # two column chunks
    (9, 9, (5, 5), (1, 1), ((2, 2), (2, 2)), None),             # 9 offset groups
    (10, 5, (3, 1), (2, 2), ((1, 1), (0, 0)), None),            # 1 wide across only
])
def test_direct_mma_plan(h, ho, ks, st, pad, want):
    plan = K.direct_mma_plan((ho, ho), ks, st)
    if want is not None:
        assert (plan["rows"], plan["cols"], plan["smem"]) == want
    assert plan["smem"] <= K.DIRECT_MMA_MAX_SMEM
    rng = np.random.default_rng(3)
    x, g = _pair(rng, 2, h, 12, ho, 10)
    want_norm = K.conv_grad_norm_sq_plain(torch.from_numpy(x), torch.from_numpy(g),
                                          ks, st, pad).numpy()
    np.testing.assert_allclose(_mma_tiling_norm(x, g, ks, st, pad, plan), want_norm,
                               rtol=1e-5)
    # One partial per block: per block of up to 3 offset groups (tensor cores: one
    # for a 3x3 conv, three for a 5x5) or per offset (fp32).
    blocks = {(3, 3): 1, (1, 1): 1, (3, 1): 1, (5, 5): 3}[ks]
    assert K.direct_partials(72, 136, ks, torch.bfloat16) == blocks * 2 * 3
    assert K.direct_partials(72, 136, ks, torch.float32) == ks[0] * ks[1] * 2 * 3
    assert K.conv_grad_norm_direct_fits((37, h, h, 72), (37, ho, ho, 136), ks, st)


def test_direct_mma_plan_limits():
    """A window too large for one position per chunk has no plan, and the
    direct kernel then does not take the layer."""
    assert K.direct_mma_plan((40, 40), (25, 25), (1, 1)) is None
    assert not K.conv_grad_norm_direct_fits((2, 40, 40, 8), (2, 40, 40, 8), (25, 25),
                                            (1, 1))
    assert K.direct_mma_plan((112, 112), (7, 7), (2, 2))["smem"] <= K.DIRECT_MMA_MAX_SMEM


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
    # A launch names one of the kernel's modes (checked before anything is built).
    with pytest.raises(ValueError, match="mode"):
        K.CONV_GRAD_NORM_DIRECT.launch(mode="tf32")
    with pytest.raises(ValueError, match="mode"):
        K.CONV_GRAD_NORM_DIRECT.launch()
    with pytest.raises(ValueError, match="mode"):
        K.EL2N.launch(mode="fp32")


def test_plain_versions_do_not_count_launches():
    K.reset_launch_counts()
    x = torch.randn(2, 4, 4, 8)
    K.conv_grad_norm_sq(x, torch.randn(2, 4, 4, 8), (3, 3), (1, 1), PAD1)
    K.el2n(torch.randn(2, 3), torch.tensor([0, 2]), torch.ones(2))
    K.conv_grad_norm_sq_v2(x.bfloat16(), torch.randn(2, 4, 4, 8).bfloat16(), (3, 3),
                           PAD1)
    assert K.launch_counts() == {name: 0 for name in (
        "conv_grad_norm_direct", "conv_grad_norm_gram", "el2n", "grand_last_layer",
        "bn_grad_norm", "conv_grad_norm_catdot", "conv_bwd_grad_norm")}
    assert K.mode_counts() == {name: {"tensor_core": 0, "fp32": 0} for name in (
        "conv_grad_norm_direct", "conv_grad_norm_catdot", "conv_bwd_grad_norm")}


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
    ("v1", 10, 20, 24, (3, 3), (1, 1), PAD1, False),            # C % 8 != 0
    ("v1", 10, 16, 30, (3, 3), (1, 1), PAD1, False),            # K % 8 != 0
    ("v1", 11, 64, 40, (3, 3), (1, 1), ((0, 2), (2, 0)), False),  # asymmetric
    ("v2", 12, 72, 136, (3, 3), (1, 1), PAD1, True),            # ragged last chunk
    ("v1", 40, 16, 16, (3, 3), (1, 1), PAD1, False),            # two column chunks
    ("v1", 9, 24, 16, (5, 5), (1, 1), ((2, 2), (2, 2)), False),  # 9 offset groups
    ("v1", 10, 32, 24, (3, 1), (2, 2), ((1, 1), (0, 0)), False),  # 1 wide across
])
def test_kernel_matches_plain_on_card(cuda_device, dtype, entry, h, c, k, ks, st,
                                      pad, bias):
    from data_diet_distributed_tpu_torch.device import set_parity_mode
    set_parity_mode(True)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    ho = (h + pad[0][0] + pad[0][1] - ks[0]) // st[0] + 1
    x = torch.randn((37, h, h, c), generator=gen, device=cuda_device).to(dtype)
    g = torch.randn((37, ho, ho, k), generator=gen, device=cuda_device).to(dtype)
    before = K.launch_counts()
    modes_before = K.mode_counts()["conv_grad_norm_direct"]
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
    if name == "conv_grad_norm_direct":
        modes = dict(modes_before)
        modes[K.DIRECT_MODES[dtype]] += 1
        assert K.mode_counts()["conv_grad_norm_direct"] == modes
    rtol = 1e-4 if dtype == torch.float32 else 1e-3
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("entry", ["v1", "v2"])
def test_direct_kernel_bitwise_on_card(cuda_device, dtype, entry):
    """Run to run, and wherever an example sits in the batch (a permutation,
    a prefix), the direct kernel gives each example the same bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn((37, 12, 12, 72), generator=gen, device=cuda_device).to(dtype)
    g = torch.randn((37, 12, 12, 136), generator=gen, device=cuda_device).to(dtype)

    def run(xx, gg):
        if entry == "v1":
            return K.conv_grad_norm_sq(xx.contiguous(), gg.contiguous(), (3, 3), (1, 1),
                                       PAD1)
        return K.conv_grad_norm_sq_v2(xx.contiguous(), gg.contiguous(), (3, 3), PAD1,
                                      use_bias=True)
    out = run(x, g)
    perm = torch.randperm(37, generator=torch.Generator().manual_seed(2)).to(cuda_device)
    assert torch.equal(run(x, g), out)
    assert torch.equal(run(x[perm], g[perm]), out[perm])
    assert torch.equal(run(x[:5], g[:5]), out[:5])


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
