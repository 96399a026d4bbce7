"""The scoring path's hand-written CUDA kernels, each beside its plain PyTorch version.

Counterpart of ``data_diet_distributed_tpu/ops/pallas_kernels.py``. Three kernels
(sources in ``ops/csrc/``, built by ``ops/build.py``) replace the four Pallas
kernels on the ResNet-18 scoring path:

* ``conv_grad_norm_direct`` — per-example ‖∂W‖²_F of a conv layer from its input
  ``x`` and output cotangent ``g``, direct form ``Σ_o ‖Σ_s x[s·stride+o] g[s]‖²``.
  Two entry points with the JAX signatures: ``conv_grad_norm_sq`` (v1: any
  stride) and ``conv_grad_norm_sq_v2`` (unit stride, bias term fused, the
  cotangent tile held in shared memory across offsets).
* ``conv_grad_norm_gram`` — the same quantity in Gram form ``Σ(PPᵀ∘GGᵀ)`` for
  small-map layers (``conv_grad_norm_sq_gram``).
* ``el2n`` — ``‖softmax(z) − onehot(y)‖₂ · mask`` per row.

Every public function takes NHWC tensors. Given CPU tensors it computes its
plain version (the same arithmetic in PyTorch ops); given CUDA tensors it
launches its kernel or raises — it never falls back. Each kernel counts its
launches (``launch_counts``), so a run can show which path it took.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

#: C and K tile edge of the direct kernel (``kTile`` in conv_grad_norm_direct.cu).
DIRECT_TILE = 64
#: Largest output-position count whose [S, 64] fp32 cotangent tile the direct
#: kernel keeps resident in shared memory (``kMaxResidentS``): 64 KB.
MAX_RESIDENT_S = 256
#: Shared memory one block may use on Hopper (227 KB).
MAX_BLOCK_SMEM = 227 * 1024
#: Row stride of the Gram kernel's channel chunks (``kStride``).
_GRAM_ROW_STRIDE = 33
#: CUDA's grid limit on the y and z dimensions.
_GRID_YZ_MAX = 65535

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class Kernel:
    """One hand-written kernel: its library entry point and a launch count.

    ``launches`` grows by one exactly where the kernel is launched (after the
    launch returned cudaSuccess); plain-version calls never touch it."""

    def __init__(self, name: str, symbol: str, argtypes: list):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._entry = None

    def _function(self):
        if self._entry is None:
            lib = build.load(self.name)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._entry = (lib, fn)
        return self._entry

    def launch(self, *args) -> None:
        lib, fn = self._function()
        err = fn(*args)
        if err != 0:
            raise RuntimeError(
                f"{self.name}: kernel launch failed with cudaError {err} "
                f"({lib.ddt_error_string(err).decode()})")
        self.launches += 1


CONV_GRAD_NORM_DIRECT = Kernel(
    "conv_grad_norm_direct", "ddt_conv_grad_norm_direct",
    [_PTR] * 4 + [_INT] * 17 + [_PTR])
CONV_GRAD_NORM_GRAM = Kernel(
    "conv_grad_norm_gram", "ddt_conv_grad_norm_gram",
    [_PTR] * 3 + [_INT] * 13 + [_PTR])
EL2N = Kernel("el2n", "ddt_el2n", [_PTR] * 4 + [_INT] * 2 + [_PTR])

KERNELS = {k.name: k for k in (CONV_GRAD_NORM_DIRECT, CONV_GRAD_NORM_GRAM, EL2N)}


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


# ------------------------------------------------------------------ checks


def _on_cuda(t: torch.Tensor, name: str) -> bool:
    """True for CUDA tensors, False for CPU ones (plain version); raises for
    any other device."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: tensors on {t.device} are not supported "
                     "(cuda launches the kernel, cpu runs the plain version)")


def _check_pair(x: torch.Tensor, g: torch.Tensor, name: str) -> None:
    if x.dim() != 4 or g.dim() != 4:
        raise ValueError(f"{name}: x and g must be NHWC [B, H, W, C] tensors, got "
                         f"{tuple(x.shape)} and {tuple(g.shape)}")
    if x.shape[0] != g.shape[0]:
        raise ValueError(f"{name}: batch mismatch {x.shape[0]} vs {g.shape[0]}")
    if x.dtype != g.dtype or x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: x and g must share float32 or bfloat16, got "
                        f"{x.dtype} and {g.dtype}")
    if x.device != g.device:
        raise ValueError(f"{name}: x on {x.device} but g on {g.device}")


def _check_geometry(x, g, kernel_size, strides, padding, name) -> None:
    (kh, kw), (sy, sx) = kernel_size, strides
    (pt, pb), (pl, pr) = padding
    want = ((x.shape[1] + pt + pb - kh) // sy + 1,
            (x.shape[2] + pl + pr - kw) // sx + 1)
    if tuple(g.shape[1:3]) != want:
        raise ValueError(f"{name}: g spatial shape {tuple(g.shape[1:3])} does not "
                         f"match the conv geometry {want}")


def _check_contiguous(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous NHWC tensors")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------- eligibility gates


def conv_grad_norm_direct_fits(x_shape, g_shape, kernel_size, strides) -> bool:
    """Whether the direct kernel's grid fits CUDA's limits for this layer:
    offsets on grid.y, C×K tiles on grid.z. (The kernel streams S in chunks, so
    no map size is too large.)"""
    del strides
    kh, kw = kernel_size
    tiles = -(-x_shape[-1] // DIRECT_TILE) * -(-g_shape[-1] // DIRECT_TILE)
    return kh * kw <= _GRID_YZ_MAX and tiles <= _GRID_YZ_MAX


def conv_grad_norm_v2_eligible(x_shape, g_shape, kernel_size, strides,
                               padding) -> bool:
    """The v2 entry: unit stride, and an output map of at most
    ``MAX_RESIDENT_S`` positions, so the block's [S, 64] fp32 cotangent tile
    stays resident in shared memory (64 KB) across every kernel offset."""
    del padding
    if tuple(strides) != (1, 1):
        return False
    s = g_shape[1] * g_shape[2]
    return s <= MAX_RESIDENT_S and conv_grad_norm_direct_fits(
        x_shape, g_shape, kernel_size, strides)


def _gram_smem_bytes(h: int, w: int, ho: int, wo: int) -> int:
    """Dynamic shared memory of one Gram-kernel block (``smem_bytes`` in
    conv_grad_norm_gram.cu): both Grams plus one channel chunk."""
    hw, s = h * w, ho * wo
    return 4 * (hw * hw + s * s + max(hw, s) * _GRAM_ROW_STRIDE)


def conv_grad_norm_gram_eligible(x_shape, g_shape, kernel_size, strides,
                                 padding) -> bool:
    """The Gram kernel: unit stride, and both per-example Grams ([H·W]² and
    [S]² fp32) fit one block's shared memory on Hopper."""
    del kernel_size, padding
    if tuple(strides) != (1, 1):
        return False
    return _gram_smem_bytes(x_shape[1], x_shape[2], g_shape[1],
                            g_shape[2]) <= MAX_BLOCK_SMEM - 1024


# ------------------------------------------------------------ plain versions


def _windows(x: torch.Tensor, kernel_size, strides, padding, out_hw):
    """Float32 input windows [B, Ho, Wo, C], one per kernel offset (oy, ox):
    window[b, r, q] = x[b, r·sy + oy − pt, q·sx + ox − pl], zero outside."""
    (kh, kw), (sy, sx) = kernel_size, strides
    (pt, pb), (pl, pr) = padding
    ho, wo = out_hw
    xp = torch.nn.functional.pad(x.float(), (0, 0, pl, pr, pt, pb))
    for oy in range(kh):
        for ox in range(kw):
            yield xp[:, oy:oy + (ho - 1) * sy + 1:sy, ox:ox + (wo - 1) * sx + 1:sx, :]


def patches(x: torch.Tensor, kernel_size, strides, padding, out_hw) -> torch.Tensor:
    """Float32 im2col patches [B, Ho·Wo, kh·kw·C] of NHWC ``x`` (features
    ordered offset-major)."""
    b = x.shape[0]
    s = out_hw[0] * out_hw[1]
    return torch.cat([w.reshape(b, s, -1) for w in
                      _windows(x, kernel_size, strides, padding, out_hw)], dim=-1)


def conv_bias_term(g: torch.Tensor) -> torch.Tensor:
    """[B] squared norm of the per-example conv bias gradient Σ_s g."""
    gs = g.float().reshape(g.shape[0], -1, g.shape[-1]).sum(dim=1)
    return (gs * gs).sum(dim=-1)


def conv_grad_norm_sq_plain(x, g, kernel_size, strides, padding,
                            use_bias: bool = False) -> torch.Tensor:
    """Plain version of the direct kernel: per offset, M_o = X_oᵀ G in fp32
    and its squared Frobenius norm, summed over offsets (+ the bias term)."""
    b, ho, wo, k = g.shape
    g2 = g.float().reshape(b, ho * wo, k)
    total = torch.zeros(b, dtype=torch.float32, device=g.device)
    for win in _windows(x, kernel_size, strides, padding, (ho, wo)):
        m = torch.bmm(win.reshape(b, ho * wo, -1).transpose(1, 2), g2)
        total = total + (m * m).sum(dim=(1, 2))
    if use_bias:
        total = total + conv_bias_term(g)
    return total


def conv_grad_norm_sq_gram_plain(x, g, kernel_size, padding,
                                 use_bias: bool = False) -> torch.Tensor:
    """Plain version of the Gram kernel: im2col patches P [B, S, kh·kw·C],
    then Σ (P Pᵀ) ∘ (G Gᵀ) in fp32 (+ the bias term)."""
    b, ho, wo, k = g.shape
    p = patches(x, kernel_size, (1, 1), padding, (ho, wo))
    g2 = g.float().reshape(b, ho * wo, k)
    pp = torch.bmm(p, p.transpose(1, 2))
    gg = torch.bmm(g2, g2.transpose(1, 2))
    total = (pp * gg).sum(dim=(1, 2))
    if use_bias:
        total = total + conv_bias_term(g)
    return total


def el2n_plain(logits, labels, mask) -> torch.Tensor:
    """Plain version of the EL2N kernel."""
    probs = torch.softmax(logits.float(), dim=-1)
    onehot = torch.nn.functional.one_hot(labels.long(), logits.shape[-1]).float()
    err = probs - onehot
    return torch.sqrt((err * err).sum(dim=-1)) * mask.float()


# ---------------------------------------------------------------- wrappers


def _direct_launch(x, g, kernel_size, strides, padding, use_bias, resident,
                   name) -> torch.Tensor:
    _check_contiguous(name, x, g)
    (kh, kw), (sy, sx) = kernel_size, strides
    (pt, _pb), (pl, _pr) = padding
    b, h, w, c = x.shape
    _, ho, wo, k = g.shape
    n_partials = kh * kw * -(-c // DIRECT_TILE) * -(-k // DIRECT_TILE)
    partials = torch.empty((b, n_partials), dtype=torch.float32, device=x.device)
    out = torch.empty(b, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        CONV_GRAD_NORM_DIRECT.launch(
            x.data_ptr(), g.data_ptr(), partials.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[x.dtype], b, h, w, c, ho, wo, k, kh, kw, sy, sx, pt, pl,
            n_partials, int(use_bias), int(resident), _stream(x))
    return out


def conv_grad_norm_sq(x: torch.Tensor, g: torch.Tensor, kernel_size, strides,
                      padding) -> torch.Tensor:
    """[B] ⟵ ‖per-example conv weight gradient‖²_F (v1 entry, any stride).

    ``x`` [B, H, W, C] is the conv input, ``g`` [B, Ho, Wo, K] the cotangent at
    its output, ``padding`` explicit ((top, bottom), (left, right)). The bias
    term is the caller's (``conv_bias_term``), as in the JAX v1 kernel."""
    name = "conv_grad_norm_sq"
    _check_pair(x, g, name)
    _check_geometry(x, g, kernel_size, strides, padding, name)
    if not conv_grad_norm_direct_fits(x.shape, g.shape, kernel_size, strides):
        raise ValueError(f"{name}: caller must check conv_grad_norm_direct_fits")
    if not _on_cuda(x, name):
        return conv_grad_norm_sq_plain(x, g, kernel_size, strides, padding)
    return _direct_launch(x, g, tuple(kernel_size), tuple(strides), padding,
                          False, False, name)


def conv_grad_norm_sq_v2(x: torch.Tensor, g: torch.Tensor, kernel_size, padding,
                         use_bias: bool = False) -> torch.Tensor:
    """[B] ⟵ ‖per-example conv weight gradient‖²_F (+ bias-grad² when
    ``use_bias``), unit stride, raw unpadded ``x`` (v2 entry)."""
    name = "conv_grad_norm_sq_v2"
    _check_pair(x, g, name)
    _check_geometry(x, g, kernel_size, (1, 1), padding, name)
    if not conv_grad_norm_v2_eligible(x.shape, g.shape, kernel_size, (1, 1),
                                      padding):
        raise ValueError(f"{name}: caller must check conv_grad_norm_v2_eligible")
    if not _on_cuda(x, name):
        return conv_grad_norm_sq_plain(x, g, kernel_size, (1, 1), padding,
                                       use_bias=use_bias)
    return _direct_launch(x, g, tuple(kernel_size), (1, 1), padding, use_bias,
                          True, name)


def conv_grad_norm_sq_gram(x: torch.Tensor, g: torch.Tensor, kernel_size,
                           padding, use_bias: bool = False) -> torch.Tensor:
    """[B] ⟵ Gram-form ‖per-example conv weight gradient‖²_F (+ bias-grad²),
    unit stride, raw unpadded ``x``."""
    name = "conv_grad_norm_sq_gram"
    _check_pair(x, g, name)
    _check_geometry(x, g, kernel_size, (1, 1), padding, name)
    if not conv_grad_norm_gram_eligible(x.shape, g.shape, kernel_size, (1, 1),
                                        padding):
        raise ValueError(f"{name}: caller must check conv_grad_norm_gram_eligible")
    if not _on_cuda(x, name):
        return conv_grad_norm_sq_gram_plain(x, g, kernel_size, padding,
                                            use_bias=use_bias)
    _check_contiguous(name, x, g)
    (kh, kw) = kernel_size
    (pt, _pb), (pl, _pr) = padding
    b, h, w, c = x.shape
    _, ho, wo, k = g.shape
    out = torch.empty(b, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        CONV_GRAD_NORM_GRAM.launch(
            x.data_ptr(), g.data_ptr(), out.data_ptr(), _DTYPE_CODE[x.dtype],
            b, h, w, c, ho, wo, k, kh, kw, pt, pl, int(use_bias), _stream(x))
    return out


def el2n(logits: torch.Tensor, labels: torch.Tensor,
         mask: torch.Tensor) -> torch.Tensor:
    """EL2N scores [B] from logits [B, C], labels [B] and mask [B]."""
    name = "el2n"
    if logits.dim() != 2 or labels.shape != logits.shape[:1] \
            or mask.shape != logits.shape[:1]:
        raise ValueError(f"{name}: want logits [B, C], labels [B], mask [B]; got "
                         f"{tuple(logits.shape)}, {tuple(labels.shape)}, "
                         f"{tuple(mask.shape)}")
    if not _on_cuda(logits, name):
        return el2n_plain(logits, labels, mask)
    if labels.device != logits.device or mask.device != logits.device:
        raise ValueError(f"{name}: logits, labels and mask must share a device")
    z = logits.float().contiguous()
    y = labels.to(torch.int32).contiguous()
    m = mask.float().contiguous()
    b, c = z.shape
    out = torch.empty(b, dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        EL2N.launch(z.data_ptr(), y.data_ptr(), m.data_ptr(), out.data_ptr(),
                    b, c, _stream(z))
    return out
