"""PyTorch port: the GraNd route kernels' plain versions against the Pallas kernels.

The last-layer GraNd, stacked-BatchNorm, cat-dot and megakernel kernels. On the
CPU the port's wrappers run their plain PyTorch versions (the tensors lie on the
CPU); the JAX side runs the real Pallas kernels in interpret mode, at the shapes
``tests/test_pallas.py`` uses. The CUDA kernels run only on a card: those tests
are marked ``cuda`` and skip here (``pytest --noconftest -m cuda
tests/test_torch_route_kernels.py`` on the card; JAX is imported only inside the
comparisons).
"""

import re

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


def _bf16(a):
    """float32 values rounded to bfloat16 (nearest even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16().float().numpy()


def _err_merge(a, b):
    """common.cuh's ``err_merge`` on [B] arrays: the sums (m, S, S_ny, Q_ny) of
    two class slices, the second after the first, rescaled to the larger max."""
    m = np.maximum(a[0], b[0])
    ca, cb = np.exp(a[0] - m), np.exp(b[0] - m)
    return m, a[1] * ca + b[1] * cb, a[2] * ca + b[2] * cb, a[3] * (ca * ca) + b[3] * (cb * cb)


def _err_sums(z, y, cls):
    """A slice's (m, S, S_ny, Q_ny) of logits ``z`` [B, n] for classes ``cls``."""
    m = z.max(axis=1)
    e = np.exp(z - m[:, None])
    not_y = cls[None, :] != y[:, None]
    return m, e.sum(axis=1), (e * not_y).sum(axis=1), (e * e * not_y).sum(axis=1)


def _split3(a):
    """grand_last_layer.cu's three bf16 parts a1 = bf16(a), a2 = bf16(a - a1),
    a3 = bf16(a - a1 - a2), as float64."""
    a1 = _bf16(a)
    a2 = _bf16(a - a1)
    a3 = _bf16(a - a1 - a2)
    return tuple(p.astype(np.float64) for p in (a1, a2, a3))


def _gll_emulate(h, w, bias, y, mask, dtype):
    """grand_last_layer.cu's arithmetic in numpy (float32 sums): w split into
    three bf16 parts (fp32 features alike), the products exact, h1·w1 summed
    apart from the small terms (h1·w2 + h1·w3, or the five above 2^-24 for
    fp32 features), ‖h‖² from the features as read, then per ``gll_plan`` split
    of the classes the sums (m, S, S_ny, Q_ny) of its two halves (one per warp
    column) merged in order, the splits merged in split order, and
    ‖p − y‖² = (Q_ny + S_ny²) / S². Returns the scores and the class ranges of
    the splits."""
    f, c = h.shape[1], w.shape[0]
    plan = K.gll_plan(f, c, getattr(torch, dtype))
    w1, w2, w3 = _split3(w)
    if dtype == "bfloat16":
        h1 = h.astype(np.float64)
        big, small = h1 @ w1.T, h1 @ w2.T + h1 @ w3.T
    else:
        h1, h2, h3 = _split3(h)
        big = h1 @ w1.T
        small = h1 @ w2.T + h2 @ w1.T + h1 @ w3.T + h2 @ w2.T + h3 @ w1.T
    z = (big.astype(np.float32) + small.astype(np.float32)) + bias
    fsq = (h * h).sum(axis=1, dtype=np.float32)
    splits = [np.arange(s * plan["classes"], min(c, (s + 1) * plan["classes"]))
              for s in range(plan["splits"])]
    sums = None
    for cls in splits:
        mid = cls[0] + plan["classes"] // 2
        halves = [cls[cls < mid], cls[cls >= mid]]
        part = _err_sums(z[:, halves[0]], y, halves[0])
        if len(halves[1]):
            part = _err_merge(part, _err_sums(z[:, halves[1]], y, halves[1]))
        sums = part if sums is None else _err_merge(sums, part)
    _, s_all, s_ny, q_ny = sums
    err = (q_ny + s_ny * s_ny) / (s_all * s_all)
    return np.sqrt(err * (fsq + 1.0)) * mask, splits


def _gll_inputs(rng, b, f, c, scale, dtype):
    """Seeded features, classifier ([C, F]), labels and mask: labels on the
    first and last class of the first two splits and on the last class, rows
    4-5 fully masked; logits scaled by ``scale`` (50 saturates the softmax)."""
    h = rng.normal(size=(b, f)).astype(np.float32)
    if dtype == "bfloat16":
        h = _bf16(h)
    w = (rng.normal(size=(c, f)) * scale / np.sqrt(f)).astype(np.float32)
    bias = (rng.normal(size=c) * 0.1 * scale).astype(np.float32)
    y = rng.integers(0, c, b).astype(np.int64)
    nc = K.gll_plan(f, c, getattr(torch, dtype))["classes"]
    y[:4] = [0, min(c, nc) - 1, min(c - 1, nc), c - 1]
    m = (rng.random(b) > 0.2).astype(np.float32)
    m[4:6] = 0.0
    return h, w, bias, y, m


@pytest.mark.parametrize("f,c,scale,dtype", [
    (64, 1, 1.0, "float32"), (64, 10, 50.0, "float32"), (64, 100, 1.0, "bfloat16"),
    (2048, 10, 1.0, "float32"), (2048, 1000, 1.0, "bfloat16"), (2048, 1000, 50.0, "float32"),
    (64, 1000, 50.0, "bfloat16"),
])
def test_gll_emulation_matches_pallas(pallas, f, c, scale, dtype):
    """The last-layer kernel's arithmetic (three-part bf16 split, split classes,
    running max, the (Q_ny + S_ny²)/S² form, the merge in split order) against
    the Pallas kernel fed the same (bf16-rounded) values, saturated rows
    included."""
    jnp, pk = pallas
    h, w, bias, y, m = _gll_inputs(np.random.default_rng(c + f), 37, f, c, scale, dtype)
    want = np.asarray(pk.grand_last_layer_pallas(
        jnp.asarray(h), jnp.asarray(w.T.copy()), jnp.asarray(bias), jnp.asarray(y),
        jnp.asarray(m), interpret=True))
    got, _ = _gll_emulate(h, w, bias, y, m, dtype)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert (got[m == 0] == 0).all()


@pytest.mark.parametrize("f,c", [(1, 1), (64, 10), (512, 16), (512, 17), (2048, 100),
                                 (2048, 1000), (100, 4097)])
def test_gll_plan_depends_on_f_c_dtype_and_covers_every_class_once(f, c):
    """``gll_plan`` takes no batch, and its splits cover classes 0..C-1 once
    each; so a row scores the same bits alone, in a slice or anywhere in a
    permuted batch (the emulation, row by row)."""
    for dtype in (torch.float32, torch.bfloat16):
        plan = K.gll_plan(f, c, dtype)
        assert plan == K.gll_plan(f, c, dtype)
        assert plan["smem"] <= K.MAX_BLOCK_SMEM
        assert plan["classes"] in (32, K.GLL_MAX_CLASSES)
        covered = np.concatenate([np.arange(s * plan["classes"], (s + 1) * plan["classes"])
                                  for s in range(plan["splits"])])
        covered = covered[covered < c]
        assert np.array_equal(covered, np.arange(c))
        assert (plan["splits"] - 1) * plan["classes"] < c
    if f * c <= 2048 * 1000:
        h, w, bias, y, m = _gll_inputs(np.random.default_rng(0), 12, f, c, 1.0, "float32")
        full, splits = _gll_emulate(h, w, bias, y, m, "float32")
        assert np.array_equal(np.sort(np.concatenate(splits)), np.arange(c))
        perm = np.random.default_rng(1).permutation(12)
        moved, _ = _gll_emulate(h[perm], w, bias, y[perm], m[perm], "float32")
        part, _ = _gll_emulate(h[3:8], w, bias, y[3:8], m[3:8], "float32")
        assert np.array_equal(moved, full[perm]) and np.array_equal(part, full[3:8])


@pytest.mark.parametrize("labels_dtype", [np.int64, np.int32])
def test_grand_last_layer_plain_bf16_matches_pallas(pallas, labels_dtype):
    """The plain version with bf16 features and int64 (or int32) labels, as the
    kernel takes them, against the Pallas kernel fed the same bf16-rounded
    features."""
    jnp, pk = pallas
    rng = np.random.default_rng(3)
    h, w, bias, y, m = _gll_inputs(rng, 37, 128, 100, 1.0, "bfloat16")
    want = pk.grand_last_layer_pallas(jnp.asarray(h), jnp.asarray(w.T.copy()),
                                      jnp.asarray(bias), jnp.asarray(y.astype(np.int32)),
                                      jnp.asarray(m), interpret=True)
    got = K.grand_last_layer(torch.from_numpy(h).bfloat16(), torch.from_numpy(w),
                             torch.from_numpy(bias), torch.from_numpy(y.astype(labels_dtype)),
                             torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_gll_constants_match_the_source():
    """The Python plan's constants are grand_last_layer.cu's and el2n.cu's."""
    import os
    from data_diet_distributed_tpu_torch.ops import build
    consts = {}
    for name in ("grand_last_layer.cu", "el2n.cu"):
        with open(os.path.join(os.path.dirname(build.__file__), "csrc", name)) as fh:
            for const, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", fh.read(),
                                          flags=re.M):
                consts[const] = eval(expr, {}, dict(consts))
    assert consts == {"kGllRows": K.GLL_ROWS, "kGllThreads": K.GLL_THREADS,
                      "kGllChunk": K.GLL_CHUNK,
                      "kGllStages": K.GLL_STAGES, "kGllMaxClasses": K.GLL_MAX_CLASSES,
                      "kGllRowBytes": K.GLL_ROW_BYTES, "kThreads": K.EL2N_THREADS,
                      "kMaxValues": K.EL2N_MAX_VALUES}


# The bfloat16 cases pin the semantics of the kernel in bf16: bf16 x and g on both
# sides (rounded to nearest even), exact products and float32 sums.
@pytest.mark.parametrize("layers,use_scale,use_bias,dtype", [
    pytest.param(1, True, True, "float32", id="1-True-True"),
    pytest.param(3, True, True, "float32", id="3-True-True"),
    pytest.param(3, True, False, "float32", id="3-True-False"),
    pytest.param(3, False, True, "float32", id="3-False-True"),
    pytest.param(1, False, False, "float32", id="1-False-False"),
    (1, True, True, "bfloat16"),
    (3, True, False, "bfloat16"),
    (3, False, True, "bfloat16"),
])
def test_bn_plain_matches_pallas(pallas, layers, use_scale, use_bias, dtype):
    jnp, pk = pallas
    rng = np.random.default_rng(4)
    bl = 16
    x, g, stats = _bn_inputs(rng, layers, bl)
    slab = np.pad(stats, ((0, 0), (0, 6), (0, 0)))    # the TPU's 8-row stats slab
    jx, jg, tx, tg = jnp.asarray(x), jnp.asarray(g), torch.from_numpy(x), torch.from_numpy(g)
    if dtype == "bfloat16":
        jx, jg = jx.astype(jnp.bfloat16), jg.astype(jnp.bfloat16)
        tx, tg = tx.bfloat16(), tg.bfloat16()
    want = pk.bn_grad_norm_sq_pallas(jx, jg, jnp.asarray(slab), bl, use_scale=use_scale,
                                     use_bias=use_bias, interpret=True)
    xs = [tx[i * bl:(i + 1) * bl].contiguous() for i in range(layers)]
    gs = [tg[i * bl:(i + 1) * bl].contiguous() for i in range(layers)]
    got = K.bn_grad_norm_sq(xs, gs, torch.from_numpy(stats), use_scale=use_scale,
                            use_bias=use_bias)
    assert got.shape == (layers * bl,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


def _bn_vector_norm(x, g, stats, plan, use_scale, use_bias):
    """The stacked-BN vector mode's thread layout in numpy (float64) for one
    layer: thread (cv, grp) of a row reads channel vector cv (``vec``
    channels) at positions grp, grp + groups, ... in steps of ``BN_UNROLL``
    positions, keeping its channels' Σ g·x and Σ g; the position groups'
    partials are added per channel in group order, then the channel terms."""
    b, c = x.shape[0], x.shape[-1]
    xr, gr = x.reshape(b, -1, c), g.reshape(b, -1, c)
    s = xr.shape[1]
    vec, groups = plan["vec"], plan["groups"]
    sgx, sgs = np.zeros((b, groups, c)), np.zeros((b, groups, c))
    seen = np.zeros((s, c), dtype=int)
    for grp in range(groups):
        for cv in range(plan["channel_vectors"]):
            ch = slice(cv * vec, (cv + 1) * vec)
            for s0 in range(grp, s, K.BN_UNROLL * groups):
                for u in range(K.BN_UNROLL):
                    pos = s0 + u * groups
                    if pos < s:
                        seen[pos, ch] += 1
                        sgx[:, grp, ch] += gr[:, pos, ch] * xr[:, pos, ch]
                        sgs[:, grp, ch] += gr[:, pos, ch]
    assert (seen == 1).all()            # every (position, channel) read once
    tgx, tgs = sgx.sum(axis=1), sgs.sum(axis=1)
    out = np.zeros(b)
    if use_scale:
        out += (((tgx - stats[0] * tgs) * stats[1]) ** 2).sum(axis=1)
    if use_bias:
        out += (tgs * tgs).sum(axis=1)
    return out


# ResNet-18's four BN shapes in both dtypes, then ragged ones: C = 72 (9 vectors of
# 8 bf16, 28 groups, 4 threads idle), C = 100 in fp32 (25 vectors of 4), S = 1.
@pytest.mark.parametrize("h,c,dtype,want", [
    (32, 64, torch.bfloat16, (8, 8, 32)), (16, 128, torch.bfloat16, (8, 16, 16)),
    (8, 256, torch.bfloat16, (8, 32, 8)), (4, 512, torch.bfloat16, (8, 64, 4)),
    (32, 64, torch.float32, (4, 16, 16)), (4, 512, torch.float32, (4, 128, 2)),
    (3, 72, torch.bfloat16, (8, 9, 28)), (5, 100, torch.float32, (4, 25, 10)),
    (1, 72, torch.bfloat16, (8, 9, 28)),
])
def test_bn_vector_plan_tiling(h, c, dtype, want):
    plan = K.bn_vector_plan(c, dtype)
    assert (plan["vec"], plan["channel_vectors"], plan["groups"]) == want
    rng = np.random.default_rng(7)
    x, g = (torch.from_numpy(rng.normal(size=(2, h, h, c)).astype(np.float32)).to(dtype)
            for _ in range(2))
    stats = np.stack([rng.normal(size=c), rng.random(c) + 0.5]).astype(np.float32)
    for use_scale, use_bias in ((True, True), (True, False), (False, True)):
        ref = K.bn_grad_norm_sq([x], [g], torch.from_numpy(stats)[None], use_scale,
                                use_bias).numpy()
        got = _bn_vector_norm(x.double().numpy(), g.double().numpy(), stats, plan,
                              use_scale, use_bias)
        np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_bn_modes():
    """The vector mode takes C a multiple of the 16-byte vector (8 bf16, 4 fp32)
    with at most ``BN_THREADS`` vectors and 16-byte-aligned layers; anything
    else takes the scalar mode. Every ResNet-18 BN layer takes the vector mode."""
    for c in (64, 128, 256, 512):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.zeros(2, 4, 4, c, dtype=dtype)
            assert K.bn_mode([x, x], [x, x]) == "vector"
    assert K.bn_vector_plan(100, torch.bfloat16) is None       # 100 % 8
    assert K.bn_vector_plan(98, torch.float32) is None         # 98 % 4
    assert K.bn_vector_plan(4096, torch.bfloat16) is None      # 512 vectors
    assert K.bn_vector_plan(2048, torch.bfloat16)["groups"] == 1
    x = torch.zeros(2, 3, 3, 100, dtype=torch.bfloat16)
    assert K.bn_mode([x], [x]) == "scalar"
    assert K.bn_mode([x.float()], [x.float()]) == "vector"
    # A layer whose memory starts 2 bytes into an allocation: not 16-byte aligned.
    off = torch.zeros(2 * 4 * 4 * 64 + 1, dtype=torch.bfloat16)[1:].view(2, 4, 4, 64)
    y = torch.zeros(2, 4, 4, 64, dtype=torch.bfloat16)
    assert off.is_contiguous() and K.bn_mode([y, off], [y, y]) == "scalar"


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


# The bf16 cases pin the semantics of the tensor-core modes: bf16 x and g (rounded
# to nearest even on both sides), exact products and float32 sums.
@pytest.mark.parametrize("h,w,c,k,pad", [
    (16, 16, 128, 128, PAD1),
    (12, 10, 128, 256, ((0, 2), (2, 0))),     # non-square map, K = 256
])
def test_catdot_plain_matches_pallas_bf16(pallas, h, w, c, k, pad):
    jnp, pk = pallas
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, h, w, c)).astype(np.float32)
    g = rng.normal(size=(2, h, w, k)).astype(np.float32)
    jx, jg = jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(g).astype(jnp.bfloat16)
    tx, tg = torch.from_numpy(x).bfloat16(), torch.from_numpy(g).bfloat16()
    want = pk.conv_grad_norm_sq_pallas(jx, jg, (3, 3), (1, 1), pad, interpret=True,
                                       catdot=True)
    got = K.conv_grad_norm_sq_catdot(tx, tg, (3, 3), pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("c,k,bias,dtype", [
    pytest.param(16, 16, True, "float32", id="16-16-True"),     # stage conv
    pytest.param(64, 64, True, "float32", id="64-64-True"),     # the TPU's packed case
    (16, 16, True, "bfloat16"),
    (64, 64, False, "bfloat16"),
    (72, 40, True, "bfloat16"),                                  # C, K off the 64 tile
])
def test_megakernel_plain_matches_pallas(pallas, c, k, bias, dtype):
    jnp, pk = pallas
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 8, 8, c)).astype(np.float32)
    g = rng.normal(size=(4, 8, 8, k)).astype(np.float32)
    w = (rng.normal(size=(3, 3, c, k)) * 0.1).astype(np.float32)   # Flax [kh, kw, C, K]
    jx, jg, tx, tg = jnp.asarray(x), jnp.asarray(g), torch.from_numpy(x), torch.from_numpy(g)
    if dtype == "bfloat16":
        jx, jg = jx.astype(jnp.bfloat16), jg.astype(jnp.bfloat16)
        tx, tg = tx.bfloat16(), tg.bfloat16()
    want_dx, want_ns = pk.conv_bwd_grad_norm_sq_pallas(
        jx, jg, jnp.asarray(w), (3, 3), PAD1, use_bias=bias, interpret=True)
    dx, ns = K.conv_bwd_grad_norm_sq(tx, tg, torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                                     (3, 3), PAD1, use_bias=bias)
    assert dx.shape == x.shape and dx.dtype == tx.dtype
    want_dx = np.asarray(want_dx.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(dx.numpy(), want_dx, rtol=1e-5, atol=1e-5)
    else:
        # Both sides round an fp32 sum of the same exact products (in another
        # order) to bf16: at most one bf16 ulp apart, 2^-7 relative at worst.
        np.testing.assert_allclose(dx.float().numpy(), want_dx, rtol=2.0 ** -7, atol=1e-6)
    np.testing.assert_allclose(ns.numpy(), np.asarray(want_ns), rtol=1e-5, atol=1e-3)


def _dx_pass(g, w, ks, pad, hw):
    """float32 conv input gradient of g ([B, Ho, Wo, K] float32) with weight w
    ([K, C, kh, kw] float32), cropped to the unpadded [B, H, W, C] input."""
    (pt, _), (pl, _) = pad
    full = torch.nn.functional.conv_transpose2d(g.permute(0, 3, 1, 2), w)
    return full[:, :, pt:pt + hw[0], pl:pl + hw[1]].permute(0, 2, 3, 1)


def _mega_dx_excess(dx, ref):
    """Largest excess over chip_smoke's dx check |dx − ref| ≤ rtol·|ref| +
    1e-5·max|ref| (bf16: rtol 2^-7, MEGA_DX_TOL), as a fraction of max|ref|."""
    rtol = 2.0 ** -7
    err = (dx.float() - ref.float()).abs() - rtol * ref.float().abs()
    return float(err.max()) / float(ref.float().abs().max())


def test_megakernel_bf16_dx_needs_the_hi_lo_weight():
    """The tensor-core dx arithmetic, emulated: bf16 g, the fp32 weight split
    into w_hi = bf16(w) and w_lo = bf16(w − w_hi), products exact and sums in
    fp32, the result rounded to bf16, meets the dx check against the plain
    version; one bf16 pass of the rounded weight does not."""
    rng = np.random.default_rng(5)
    b, h, c, k, ks, pad = 4, 8, 32, 64, (3, 3), PAD1
    x = torch.from_numpy(rng.normal(size=(b, h, h, c)).astype(np.float32)).bfloat16()
    g = torch.from_numpy(rng.normal(size=(b, h, h, k)).astype(np.float32)).bfloat16()
    w = torch.from_numpy((rng.normal(size=(k, c, *ks)) * 0.05).astype(np.float32))
    ref, _ = K.conv_bwd_grad_norm_sq(x, g, w, ks, pad)      # the plain version, bf16 out
    hi = w.bfloat16()
    lo = (w - hi.float()).bfloat16()
    gf = g.float()
    pair = (_dx_pass(gf, hi.float(), ks, pad, (h, h))
            + _dx_pass(gf, lo.float(), ks, pad, (h, h))).bfloat16()
    single = _dx_pass(gf, hi.float(), ks, pad, (h, h)).bfloat16()
    assert _mega_dx_excess(pair, ref) <= 1e-5
    assert _mega_dx_excess(single, ref) > 1e-5
    # The pair carries the weight to ~2^-17 of its size, one bf16 to ~2^-9.
    assert float((hi.float() + lo.float() - w).abs().max()) <= 2.0 ** -17 * float(w.abs().max())


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
    = 0; the megakernel takes unit stride; the last-layer kernel streams F and
    splits C, so it takes any F, C ≥ 1; the BN kernel 4-D activations."""
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
    assert K.grand_last_layer_eligible(60000, 10)
    assert K.grand_last_layer_eligible(1, 100000)
    assert not K.grand_last_layer_eligible(0, 10)
    assert not K.grand_last_layer_eligible(2048, 0)
    assert K.bn_grad_norm_eligible((8, 6, 6, 32))
    assert not K.bn_grad_norm_eligible((8, 32))


def _mega_dx_tiling(g, w, ks, pad, hw, plan):
    """The megakernel's tensor-core dx role in numpy (float64): each block's
    three tiles (one per warpgroup, example-major), each staging one cotangent
    band with a (kh − 1, kw − 1) halo (zero outside the map), and each offset's
    window read from the band at (r + kh − 1 − oy, q + kw − 1 − ox), as the
    kernel's ldmatrix addresses do."""
    (kh, kw), ((pt, _), (pl, _)) = ks, pad
    b, ho, wo, k = g.shape
    h, wd = hw
    rows, cols = plan["rows"], plan["cols"]
    dx = np.zeros((b, h, wd, w.shape[1]))
    seen = np.zeros((b, h, wd), dtype=int)
    for blk in range(plan["bpc"]):
        for wg in range(3):
            unit = blk * 3 + wg
            if unit >= b * plan["ptiles"]:
                continue
            bi, t = divmod(unit, plan["ptiles"])
            y0, x0 = t // plan["tiles_q"] * rows, t % plan["tiles_q"] * cols
            nr, nq = min(rows, h - y0), min(cols, wd - x0)
            band = np.zeros((plan["band_h"], plan["band_w"], k))
            for by in range(plan["band_h"]):
                for bx in range(plan["band_w"]):
                    gy, gx = y0 + pt - (kh - 1) + by, x0 + pl - (kw - 1) + bx
                    if 0 <= gy < ho and 0 <= gx < wo:
                        band[by, bx] = g[bi, gy, gx]
            for s in range(64 * plan["mt"]):
                r, q = divmod(s, cols)
                if r >= nr or q >= nq:
                    continue
                seen[bi, y0 + r, x0 + q] += 1
                for oy in range(kh):
                    for ox in range(kw):
                        dx[bi, y0 + r, x0 + q] += (band[r + kh - 1 - oy, q + kw - 1 - ox]
                                                   @ w[:, :, oy, ox])
    assert (seen == 1).all()            # the tiles cover every position once
    return dx


# ResNet-18's three megakernel geometries at CIFAR-10 size (4 + 3 + 3 layers at
# batch 512), then ragged ones.
@pytest.mark.parametrize("b,h,w,ks,pad,want", [
    (512, 32, 32, (3, 3), PAD1, (2, 4, 32, 141840, 1366)),
    (512, 16, 16, (3, 3), PAD1, (2, 8, 16, 134928, 342)),
    (512, 8, 8, (3, 3), PAD1, (1, 8, 8, 111888, 171)),
    (5, 12, 12, (3, 3), PAD1, None),
    (4, 10, 10, (3, 3), ((0, 2), (2, 0)), None),
    (4, 9, 11, (3, 2), ((1, 1), (1, 0)), None),
    (3, 40, 40, (3, 3), PAD1, None),                     # two column tiles
])
def test_mega_dx_plan(b, h, w, ks, pad, want):
    plan = K.mega_dx_plan(b, (h, w), ks)
    if want is not None:
        assert (plan["mt"], plan["rows"], plan["cols"], plan["smem"], plan["bpc"]) == want
    assert plan["smem"] <= K.MEGA_DX_MAX_SMEM
    assert plan["rows"] * plan["cols"] <= 64 * plan["mt"]
    if b > 8:
        return
    rng = np.random.default_rng(4)
    ho = h + pad[0][0] + pad[0][1] - ks[0] + 1
    wo = w + pad[1][0] + pad[1][1] - ks[1] + 1
    g = rng.normal(size=(b, ho, wo, 10)).astype(np.float32)
    wt = rng.normal(size=(10, 6, *ks)).astype(np.float32)
    want_dx, _ = K.conv_bwd_grad_norm_sq(torch.zeros(b, h, w, 6), torch.from_numpy(g),
                                         torch.from_numpy(wt), ks, pad)
    np.testing.assert_allclose(_mega_dx_tiling(g, wt, ks, pad, (h, w), plan),
                               want_dx.numpy(), rtol=1e-5, atol=1e-5)


def _catdot_tiling_norm(x, g, ks, pad, plan):
    """The cat-dot kernel's tensor-core tiling in numpy (float64): per chunk of
    the padded Ho × Wp grid an x band of rows + kh − 1 rows and a g band with a
    (kw − 1)-column halo, zero outside the maps; offset (oy, ox) reads A at
    x band (rr + oy, qq) and B at g band (rr, qq + kw − 1 − ox), as the
    kernel's ldmatrix addresses do."""
    (kh, kw), ((pt, _), (pl, _)) = ks, pad
    b, h, w, c = x.shape
    _, ho, wo, k = g.shape
    wp = wo + kw - 1
    rows, cols = plan["rows"], plan["cols"]
    m = np.zeros((b, kh, kw, c, k))
    seen = np.zeros((ho, wp), dtype=int)
    for ci in range(plan["chunks_r"] * plan["chunks_q"]):
        r0, w0 = ci // plan["chunks_q"] * rows, ci % plan["chunks_q"] * cols
        nr, nq = min(rows, ho - r0), min(cols, wp - w0)
        xband = np.zeros((b, rows + kh - 1, cols, c))
        for by in range(rows + kh - 1):
            for bx in range(cols):
                iy, ix = r0 + by - pt, w0 + bx - pl
                if 0 <= iy < h and 0 <= ix < w:
                    xband[:, by, bx] = x[:, iy, ix]
        gband = np.zeros((b, rows, plan["gband_w"], k))
        for by in range(rows):
            for bx in range(plan["gband_w"]):
                gy, gx = r0 + by, w0 + bx - (kw - 1)
                if gy < ho and 0 <= gx < wo:
                    gband[:, by, bx] = g[:, gy, gx]
        s = np.arange(-(-nr * cols // 16) * 16)
        rr, qq = s // cols, s % cols
        ok = (rr < nr) & (qq < nq)
        rr, qq = rr[ok], qq[ok]
        seen[r0 + rr, w0 + qq] += 1
        for oy in range(kh):
            for ox in range(kw):
                m[:, oy, ox] += np.einsum("bnc,bnk->bck", xband[:, rr + oy, qq],
                                          gband[:, rr, qq + kw - 1 - ox])
    assert (seen == 1).all()            # the chunks cover the padded grid once
    assert plan["xband"] == (rows + kh - 1) * cols
    return (m * m).sum(axis=(1, 2, 3, 4))


@pytest.mark.parametrize("h,w,ks,pad,want", [
    (16, 16, (3, 3), PAD1, (7, 18, 87120)),              # ResNet-18's 3 cat-dot layers
    (12, 10, (3, 3), ((0, 2), (2, 0)), None),
    (9, 14, (3, 2), ((1, 1), (1, 0)), None),
    (10, 40, (3, 3), PAD1, None),                        # two column chunks
])
def test_catdot_mma_plan(h, w, ks, pad, want):
    ho = h + pad[0][0] + pad[0][1] - ks[0] + 1
    wo = w + pad[1][0] + pad[1][1] - ks[1] + 1
    plan = K.catdot_mma_plan((ho, wo), ks)
    if want is not None:
        assert (plan["rows"], plan["cols"], plan["smem"]) == want
    assert plan["smem"] <= K.DIRECT_MMA_MAX_SMEM
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, h, w, 12)).astype(np.float32)
    g = rng.normal(size=(2, ho, wo, 10)).astype(np.float32)
    want_norm = K.conv_grad_norm_sq_plain(torch.from_numpy(x), torch.from_numpy(g), ks,
                                          (1, 1), pad).numpy()
    np.testing.assert_allclose(_catdot_tiling_norm(x, g, ks, pad, plan), want_norm,
                               rtol=1e-5)


def test_tensor_core_gates_and_partials_at_resnet18():
    """ResNet-18 (CIFAR-10 geometry, batch 512): the megakernel takes the ten
    unit-stride 3x3 convs of stages 1-3 and cat-dot the three of stage 2, and
    the tensor-core partial counts are the direct walk's (one block of three
    offset groups per example: one partial per C×K tile). A kernel whose hi/lo
    weight rows do not fit the dx role's shared memory has no dx plan and is
    refused; fp32 partial counts are the CUDA-core tiles'."""
    layers = [((512, 32, 32, 64), 4), ((512, 16, 16, 128), 3), ((512, 8, 8, 256), 3)]
    for shape, _ in layers:
        assert K.conv_bwd_grad_norm_eligible(shape, shape, (3, 3), (1, 1))
        c = shape[-1]
        assert K.mega_partials(c, c, (3, 3), torch.bfloat16) == (c // 64) ** 2
        assert K.mega_partials(c, c, (3, 3), torch.float32) == 0
    assert sum(n for _, n in layers) == 10
    assert K.conv_grad_norm_catdot_eligible((512, 16, 16, 128), (512, 16, 16, 128), (3, 3),
                                            (1, 1), PAD1)
    assert K.catdot_partials(128, 128, (3, 3), torch.bfloat16) == 4
    assert K.catdot_partials(128, 128, (3, 3), torch.float32) == 36
    assert K.catdot_partials(128, 256, (3, 2), torch.bfloat16) == 1 * 2 * 4
    assert K.catdot_partials(128, 128, (4, 3), torch.bfloat16) == 2 * 4   # 6 groups, 2 blocks
    assert K.mega_dx_plan(8, (9, 9), (5, 5)) is None
    assert not K.conv_bwd_grad_norm_eligible((8, 9, 9, 72), (8, 9, 9, 136), (5, 5), (1, 1))
    assert K.conv_bwd_grad_norm_eligible((8, 9, 9, 72), (8, 9, 8, 136), (3, 4), (1, 1))


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
    K.conv_grad_norm_sq_catdot(x.bfloat16(), torch.randn(2, 16, 16, 128).bfloat16(), (3, 3),
                               PAD1)
    K.conv_bwd_grad_norm_sq(x[..., :8].bfloat16(), torch.randn(2, 16, 16, 8).bfloat16(),
                            torch.randn(8, 8, 3, 3), (3, 3), PAD1)
    K.bn_grad_norm_sq([x.bfloat16()], [x.bfloat16()], torch.ones(1, 2, 128))
    K.bn_grad_norm_sq([x[..., :100].contiguous()], [x[..., :100].contiguous()],
                      torch.ones(1, 2, 100))
    assert set(K.launch_counts().values()) == {0}
    assert K.mode_counts() == {
        **{name: {"tensor_core": 0, "fp32": 0} for name in (
            "conv_grad_norm_direct", "conv_grad_norm_gram", "conv_grad_norm_catdot",
            "conv_bwd_grad_norm")},
        "bn_grad_norm": {"vector": 0, "scalar": 0}}


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


def _cuda_kernels_per_call(call):
    """CUDA kernels (and copies or memsets) one warmed-up ``call()`` runs, as
    ``torch.profiler`` sees them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("labels_dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("b,f,c", [(37, 64, 10), (300, 2048, 1000), (70, 2048, 100),
                                   (37, 98, 20), (37, 64, 33)])
def test_grand_last_layer_kernel_matches_plain_on_card(cuda_device, dtype, labels_dtype, b,
                                                       f, c):
    """bf16 or fp32 features and int64 or int32 labels as given, one launch,
    within rtol 1e-4 (fp32) or 1e-3 (bf16) of the plain version on the same
    inputs, bitwise from run to run, on a permuted batch and on a 5-row slice.
    F = 98 stages by scalar loads (not a multiple of the 16-byte unit)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    h = torch.randn((b, f), generator=gen, device=cuda_device).to(dtype)
    w = torch.randn((c, f), generator=gen, device=cuda_device) * f ** -0.5
    bias = torch.randn(c, generator=gen, device=cuda_device)
    y = torch.randint(0, c, (b,), generator=gen, device=cuda_device).to(labels_dtype)
    m = (torch.rand(b, generator=gen, device=cuda_device) > 0.1).float()
    before = K.launch_counts()["grand_last_layer"]
    got = K.grand_last_layer(h, w, bias, y, m)
    torch.cuda.synchronize()
    assert K.launch_counts()["grand_last_layer"] == before + 1
    np.testing.assert_allclose(got.cpu().numpy(),
                               K.grand_last_layer_plain(h, w, bias, y, m).cpu().numpy(),
                               rtol=_rtol(dtype), atol=1e-6)
    perm = torch.randperm(b, generator=torch.Generator().manual_seed(2)).to(cuda_device)
    assert torch.equal(K.grand_last_layer(h, w, bias, y, m), got)
    assert torch.equal(K.grand_last_layer(h[perm].contiguous(), w, bias, y[perm], m[perm]),
                       got[perm])
    assert torch.equal(K.grand_last_layer(h[3:8].contiguous(), w, bias, y[3:8], m[3:8]),
                       got[3:8])


@pytest.mark.cuda
@pytest.mark.parametrize("c", [10, 1000])
def test_grand_last_layer_one_launch_per_call_on_card(cuda_device, c):
    """Under half precision (bf16 features, int64 labels) a call runs the kernel
    alone: no copy, cast or memset before it."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    h = torch.randn((512, 2048), generator=gen, device=cuda_device).bfloat16()
    w = torch.randn((c, 2048), generator=gen, device=cuda_device) * 2048 ** -0.5
    bias = torch.zeros(c, device=cuda_device)
    y = torch.randint(0, c, (512,), generator=gen, device=cuda_device)
    m = torch.ones(512, device=cuda_device)
    names = _cuda_kernels_per_call(lambda: K.grand_last_layer(h, w, bias, y, m))
    assert len(names) == 1 and "gll_kernel" in names[0], names


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layers,hw,ch,use_scale,use_bias", [
    (1, 6, 32, True, True), (3, 7, 100, True, False), (2, 4, 512, False, True),
    (5, 32, 64, True, True),                                   # ResNet-18 stage 1
    (3, 3, 72, True, True),                                    # 9 vectors of 8 bf16
    (3, 1, 98, False, True),                                   # S = 1, scalar mode
    (1, 5, 100, True, True),                                   # scalar in bf16
])
def test_bn_kernel_matches_plain_on_card(cuda_device, dtype, layers, hw, ch, use_scale,
                                         use_bias):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    xs = [torch.randn((37, hw, hw, ch), generator=gen, device=cuda_device).to(dtype)
          for _ in range(layers)]
    gs = [torch.randn((37, hw, hw, ch), generator=gen, device=cuda_device).to(dtype)
          for _ in range(layers)]
    stats = torch.rand((layers, 2, ch), generator=gen, device=cuda_device) + 0.5
    mode = "vector" if K.bn_vector_plan(ch, dtype) is not None else "scalar"
    assert K.bn_mode(xs, gs) == mode
    before = K.mode_counts()["bn_grad_norm"]
    got = K.bn_grad_norm_sq(xs, gs, stats, use_scale, use_bias)
    torch.cuda.synchronize()
    modes = dict(before)
    modes[mode] += 1
    assert K.mode_counts()["bn_grad_norm"] == modes
    want = K.bn_grad_norm_sq_plain(xs, gs, stats, use_scale, use_bias)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=_rtol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ch", [512, 100])
def test_bn_kernel_bitwise_on_card(cuda_device, dtype, ch):
    """Run to run, and wherever an example sits in its layer's batch (every
    layer permuted alike, a prefix), the stacked-BN kernel gives each row the
    same bits, in both modes."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    xs = [torch.randn((37, 4, 4, ch), generator=gen, device=cuda_device).to(dtype)
          for _ in range(3)]
    gs = [torch.randn((37, 4, 4, ch), generator=gen, device=cuda_device).to(dtype)
          for _ in range(3)]
    stats = torch.rand((3, 2, ch), generator=gen, device=cuda_device) + 0.5

    def run(idx):
        return K.bn_grad_norm_sq([x[idx].contiguous() for x in xs],
                                 [g[idx].contiguous() for g in gs], stats).reshape(3, -1)
    every = torch.arange(37, device=cuda_device)
    out = run(every)
    perm = torch.randperm(37, generator=torch.Generator().manual_seed(2)).to(cuda_device)
    assert torch.equal(run(every), out)
    assert torch.equal(run(perm), out[:, perm])
    assert torch.equal(run(every[:5]), out[:, :5])


def _check_one_launch(name, dtype, before, modes_before):
    """Exactly one launch of kernel ``name`` since the counts ``before``, in
    the mode its dtype selects."""
    assert K.launch_counts()[name] == before[name] + 1
    modes = dict(modes_before)
    modes[K.DIRECT_MODES[dtype]] += 1
    assert K.mode_counts()[name] == modes


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w,c,k,ks,pad", [
    (16, 16, 128, 128, (3, 3), PAD1),
    (12, 12, 128, 256, (3, 3), ((0, 2), (2, 0))),
    (12, 10, 128, 256, (3, 3), ((0, 2), (2, 0))),             # non-square map
    (9, 14, 128, 128, (3, 2), ((1, 1), (1, 0))),               # a (3, 2) kernel
    (10, 40, 128, 128, (3, 3), PAD1),                          # two column chunks
])
def test_catdot_kernel_matches_plain_on_card(cuda_device, dtype, h, w, c, k, ks, pad):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    ho = h + pad[0][0] + pad[0][1] - ks[0] + 1
    wo = w + pad[1][0] + pad[1][1] - ks[1] + 1
    x = torch.randn((37, h, w, c), generator=gen, device=cuda_device).to(dtype)
    g = torch.randn((37, ho, wo, k), generator=gen, device=cuda_device).to(dtype)
    before, modes_before = K.launch_counts(), K.mode_counts()["conv_grad_norm_catdot"]
    got = K.conv_grad_norm_sq_catdot(x, g, ks, pad)
    torch.cuda.synchronize()
    _check_one_launch("conv_grad_norm_catdot", dtype, before, modes_before)
    want = K.conv_grad_norm_sq_plain(x, g, ks, (1, 1), pad)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=_rtol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,c,k,ks,pad,bias", [
    (8, 16, 16, (3, 3), PAD1, True),
    (9, 72, 136, (3, 3), PAD1, False),
    (7, 64, 48, (3, 2), ((0, 2), (1, 0)), True),
    (10, 20, 30, (3, 3), ((0, 2), (2, 0)), False),             # C, K % 8 != 0
    (40, 16, 16, (3, 3), PAD1, False),                         # two column tiles
    (5, 21, 64, (3, 3), PAD1, True),                           # odd C, a 25-position map
])
def test_megakernel_matches_plain_on_card(cuda_device, dtype, h, c, k, ks, pad, bias):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    ho = h + pad[0][0] + pad[0][1] - ks[0] + 1
    wo = h + pad[1][0] + pad[1][1] - ks[1] + 1
    x = torch.randn((37, h, h, c), generator=gen, device=cuda_device).to(dtype)
    g = torch.randn((37, ho, wo, k), generator=gen, device=cuda_device).to(dtype)
    w = torch.randn((k, c, *ks), generator=gen, device=cuda_device) * 0.1
    before, modes_before = K.launch_counts(), K.mode_counts()["conv_bwd_grad_norm"]
    dx, ns = K.conv_bwd_grad_norm_sq(x, g, w, ks, pad, use_bias=bias)
    torch.cuda.synchronize()
    _check_one_launch("conv_bwd_grad_norm", dtype, before, modes_before)
    want_dx, want_ns = K.conv_bwd_grad_norm_sq_plain(x, g, w, ks, pad, use_bias=bias)
    assert dx.dtype == dtype
    np.testing.assert_allclose(ns.cpu().numpy(), want_ns.cpu().numpy(), rtol=_rtol(dtype))
    # chip_smoke's dx check (MEGA_DX_TOL): |dx - ref| <= rtol |ref| + 1e-5 max|ref|; in
    # bf16 both sides round an fp32 sum to bf16, which may land one ulp apart.
    tol = 1e-4 if dtype == torch.float32 else 2 ** -7
    err = (dx.float() - want_dx.float()).abs()
    scale = float(want_dx.float().abs().max())
    assert float((err - tol * want_dx.float().abs()).max()) <= 1e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["catdot", "megakernel"])
def test_route_kernels_bitwise_on_card(cuda_device, dtype, kernel):
    """Run to run, and wherever an example sits in the batch (a permutation,
    a prefix), cat-dot and the megakernel give each example the same bits (dx
    and norm)."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    c, k = (128, 256) if kernel == "catdot" else (72, 136)
    x = torch.randn((37, 12, 12, c), generator=gen, device=cuda_device).to(dtype)
    g = torch.randn((37, 12, 12, k), generator=gen, device=cuda_device).to(dtype)
    w = torch.randn((k, c, 3, 3), generator=gen, device=cuda_device) * 0.1

    def run(xx, gg):
        if kernel == "catdot":
            return (K.conv_grad_norm_sq_catdot(xx.contiguous(), gg.contiguous(), (3, 3), PAD1),)
        return K.conv_bwd_grad_norm_sq(xx.contiguous(), gg.contiguous(), w, (3, 3), PAD1,
                                       use_bias=True)
    out = run(x, g)
    perm = torch.randperm(37, generator=torch.Generator().manual_seed(2)).to(cuda_device)
    for a, b, p, q in zip(run(x, g), out, run(x[perm], g[perm]), run(x[:5], g[:5])):
        assert torch.equal(a, b)
        assert torch.equal(p, b[perm])
        assert torch.equal(q, b[:5])


@pytest.mark.cuda
@pytest.mark.parametrize("h,c", [(32, 64), (16, 128), (8, 256)])
def test_megakernel_norm_is_the_direct_walk_on_card(cuda_device, h, c):
    """The megakernel's bf16 norm role runs the direct kernel's tensor-core
    walk: its norm equals the direct kernel's to the bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn((9, h, h, c), generator=gen, device=cuda_device).bfloat16()
    g = torch.randn((9, h, h, c), generator=gen, device=cuda_device).bfloat16()
    w = torch.randn((c, c, 3, 3), generator=gen, device=cuda_device) * 0.05
    _, ns = K.conv_bwd_grad_norm_sq(x, g, w, (3, 3), PAD1)
    assert torch.equal(ns, K.conv_grad_norm_sq(x, g, (3, 3), (1, 1), PAD1))
