"""The scoring path's hand-written CUDA kernels, each beside its plain PyTorch version.

Counterpart of ``data_diet_distributed_tpu/ops/pallas_kernels.py``. Seven kernels
(sources in ``ops/csrc/``, built by ``ops/build.py``) replace its eight Pallas
kernels:

* ``conv_grad_norm_direct`` — per-example ‖∂W‖²_F of a conv layer from its input
  ``x`` and output cotangent ``g``, direct form ``Σ_o ‖Σ_s x[s·stride+o] g[s]‖²``.
  Two entry points with the JAX signatures: ``conv_grad_norm_sq`` (v1: any
  stride) and ``conv_grad_norm_sq_v2`` (unit stride, bias term fused). In bf16
  one staged input band serves every offset of a 3x3 conv
  (``direct_mma_plan``); in fp32 the v2 entry keeps the cotangent tile in
  shared memory across offsets.
* ``conv_grad_norm_gram`` — the same quantity in Gram form ``Σ(PPᵀ∘GGᵀ)`` for
  small-map layers (``conv_grad_norm_sq_gram``): several examples per block,
  one warp per (example, Gram), rows staged by ``cp.async`` in chunks as wide
  as shared memory allows (``gram_plan``: whole rows at ResNet-18's stage 4).
* ``el2n`` — ``‖softmax(z) − onehot(y)‖₂ · mask`` per row, from bf16 or fp32
  logits and int64 or int32 labels as given (``el2n_plan``: lane groups per
  row, a row read once).
* ``grand_last_layer`` — the classifier product and the last-layer GraNd score
  ``‖p − y‖·sqrt(‖h‖² + 1)·mask`` in one kernel: tiles of rows share each
  staged chunk of the weight, the product on the tensor cores with the fp32
  weight split into three bf16 parts, the classes split across blocks and
  their softmax-error sums merged in split order (``gll_plan``).
* ``bn_grad_norm`` — eval-mode BatchNorm per-example grad-norm², same-shape
  layers stacked in one launch (``bn_grad_norm_sq``).
* ``conv_grad_norm_catdot`` — the conv ‖∂W‖² at unit stride as one
  ``[kh·C, kw·K]`` product per example (``conv_grad_norm_sq_catdot``).
* ``conv_bwd_grad_norm`` — the megakernel: a conv's input cotangent ``dx`` and
  its ‖∂W‖² (+ bias term) from one launch (``conv_bwd_grad_norm_sq``).

The direct, cat-dot, megakernel and Gram kernels each have two modes, chosen
by dtype and counted apart (``DIRECT_MODES``, ``mode_counts``): bf16 on the
tensor cores (``mma.sync``; the direct walk of ``conv_norm_mma.cuh`` serves the
direct kernel and the megakernel's norm, the cat-dot kernel walks the same loop
with its own staging, ``catdot_mma_plan``, the megakernel's dx is an implicit
GEMM over a staged cotangent band, ``mega_dx_plan``, with the fp32 weight split
into a bf16 hi/lo pair, and the Gram kernel forms X Xᵀ and G Gᵀ from one
``ldmatrix`` per 16 rows and 16 channels), fp32 on the CUDA cores (the parity
mode's 1e-4 against an fp32 reference rules out TF32). The stacked-BN kernel
has two modes chosen by layout (``BN_MODES``, ``bn_mode``): ``vector`` (16-byte
loads, a thread per channel vector and position group, ``bn_vector_plan``)
where C is a multiple of the vector width and the layers are 16-byte aligned,
``scalar`` otherwise.

Every public function takes NHWC tensors. Given CPU tensors it computes its
plain version (the same arithmetic in PyTorch ops); given CUDA tensors it
launches its kernel or raises — it never falls back. Each kernel counts its
launches (``launch_counts``), and a kernel with modes counts each launch
under its mode too (``mode_counts``), so a run can show which path it took.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

#: C and K tile edge of the direct kernel in both modes (``kTile``, ``kMmaTile``).
DIRECT_TILE = 64
#: Largest output-position count whose [S, 64] fp32 cotangent tile the direct
#: kernel's fp32 mode keeps resident in shared memory (``kMaxResidentS``): 64 KB.
MAX_RESIDENT_S = 256
#: The direct kernel's tensor-core mode (conv_norm_mma.cuh): kernel offsets one
#: warpgroup accumulates (``kMmaOffsets``), warpgroups of a block at most
#: (``kMmaGroups``), output positions a staged chunk aims at
#: (``kMmaChunk``) and its most columns (``kMmaMaxCols``), the cp.async ring
#: depth (``kMmaStages``), one shared row of 64 bf16 channels padded to 72
#: (``kRowBytes``) and a block's shared-memory budget, half an SM's
#: (``kMmaMaxSmem``).
DIRECT_MMA_OFFSETS = 3
DIRECT_MMA_GROUPS = 3
DIRECT_MMA_CHUNK = 128
DIRECT_MMA_MAX_COLS = 32
DIRECT_MMA_STAGES = 2
DIRECT_MMA_ROW_BYTES = 144
DIRECT_MMA_MAX_SMEM = 113 * 1024
#: The mode of the direct, cat-dot and megakernel kernels for each input dtype.
DIRECT_MODES = {torch.bfloat16: "tensor_core", torch.float32: "fp32"}
#: The megakernel's tensor-core dx role (conv_bwd_grad_norm.cu): K channels of
#: one ring buffer (``kDxK``), one shared cotangent row of 16 channels padded to
#: 24 (``kDxRowElems``, 48 bytes), a tile's most input columns
#: (``kDxMaxCols``) and the role's shared-memory budget (``kDxMaxSmem``).
MEGA_DX_K = 16
MEGA_DX_ROW_BYTES = 48
MEGA_DX_MAX_COLS = 32
MEGA_DX_MAX_SMEM = 200 * 1024
#: Shared memory one block may use on Hopper (227 KB).
MAX_BLOCK_SMEM = 227 * 1024
#: The Gram kernel (conv_grad_norm_gram.cu): examples of a block at most
#: (``kGramExamples``, two warps each), its ring depth at most in chunks
#: (``kGramStages``), the narrowest chunk of a staged row (``kGramUnitBytes``
#: of channels), the padding after each staged row (``kGramRowPad``), a
#: block's target shared memory (``kGramBlockSmem``: two blocks per SM) and
#: its most (``kGramMaxSmem``).
GRAM_EXAMPLES = 4
GRAM_STAGES = 4
GRAM_UNIT_BYTES = 128
GRAM_ROW_PAD = 16
GRAM_BLOCK_SMEM = 113 * 1024
GRAM_MAX_SMEM = 226 * 1024
#: The last-layer GraNd kernel (grand_last_layer.cu): rows of a block's tile
#: (``kGllRows``), its threads (``kGllThreads``), features of a staged chunk
#: (``kGllChunk``), the cp.async ring depth (``kGllStages``), classes of one
#: split at most (``kGllMaxClasses``) and a staged bf16 row of one chunk,
#: padded (``kGllRowBytes``).
GLL_ROWS = 64
GLL_THREADS = 256
GLL_CHUNK = 64
GLL_STAGES = 3
GLL_MAX_CLASSES = 64
GLL_ROW_BYTES = 144
#: The EL2N kernel (el2n.cu): threads of a block (``kThreads``) and logits a lane
#: holds per tile at most (``kMaxValues``).
EL2N_THREADS = 256
EL2N_MAX_VALUES = 32
#: CUDA's grid limits on the x and on the y and z dimensions.
_GRID_X_MAX = 2**31 - 1
_GRID_YZ_MAX = 65535
#: Layers one stacked-BatchNorm launch takes (``kMaxLayers`` in bn_grad_norm.cu);
#: larger stacks launch once per chunk of this many layers.
BN_MAX_LAYERS = 64
#: The stacked-BN kernel's threads per block (``kThreads``) and positions a
#: thread loads per step in the vector mode (``kUnroll``).
BN_THREADS = 256
BN_UNROLL = 4
#: The stacked-BN kernel's modes.
BN_MODES = ("vector", "scalar")
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_PTRS = ctypes.POINTER(ctypes.c_void_p)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class Kernel:
    """One hand-written kernel: its library entry point and a launch count.

    ``launches`` grows by one exactly where the kernel is launched (after the
    launch returned cudaSuccess); plain-version calls never touch it. A kernel
    with ``modes`` also counts each launch under the mode it took
    (``mode_launches``)."""

    def __init__(self, name: str, symbol: str, argtypes: list, modes: tuple = ()):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.mode_launches = dict.fromkeys(modes, 0)
        self._entry = None

    def _function(self):
        if self._entry is None:
            lib = build.load(self.name)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._entry = (lib, fn)
        return self._entry

    def launch(self, *args, mode: str | None = None) -> None:
        if mode not in (set(self.mode_launches) or {None}):
            raise ValueError(f"{self.name}: mode {mode!r}, want one of "
                             f"{sorted(self.mode_launches)}")
        lib, fn = self._function()
        err = fn(*args)
        if err != 0:
            raise RuntimeError(
                f"{self.name}: kernel launch failed with cudaError {err} "
                f"({lib.ddt_error_string(err).decode()})")
        self.launches += 1
        if mode is not None:
            self.mode_launches[mode] += 1


CONV_GRAD_NORM_DIRECT = Kernel(
    "conv_grad_norm_direct", "ddt_conv_grad_norm_direct",
    [_PTR] * 4 + [_INT] * 17 + [_PTR], modes=tuple(DIRECT_MODES.values()))
CONV_GRAD_NORM_GRAM = Kernel(
    "conv_grad_norm_gram", "ddt_conv_grad_norm_gram",
    [_PTR] * 3 + [_INT] * 13 + [_PTR], modes=tuple(DIRECT_MODES.values()))
EL2N = Kernel("el2n", "ddt_el2n", [_PTR, _INT, _PTR, _INT, _PTR, _PTR, _INT, _INT, _PTR])
GRAND_LAST_LAYER = Kernel("grand_last_layer", "ddt_grand_last_layer",
                          [_PTR, _INT, _PTR, _PTR, _PTR, _INT] + [_PTR] * 4
                          + [_INT] * 3 + [_PTR])
BN_GRAD_NORM = Kernel("bn_grad_norm", "ddt_bn_grad_norm",
                      [_PTRS, _PTRS, _PTR, _PTR] + [_INT] * 8 + [_PTR], modes=BN_MODES)
CONV_GRAD_NORM_CATDOT = Kernel("conv_grad_norm_catdot", "ddt_conv_grad_norm_catdot",
                               [_PTR] * 4 + [_INT] * 13 + [_PTR],
                               modes=tuple(DIRECT_MODES.values()))
CONV_BWD_GRAD_NORM = Kernel("conv_bwd_grad_norm", "ddt_conv_bwd_grad_norm",
                            [_PTR] * 6 + [_INT] * 14 + [_PTR],
                            modes=tuple(DIRECT_MODES.values()))

KERNELS = {k.name: k for k in (CONV_GRAD_NORM_DIRECT, CONV_GRAD_NORM_GRAM, EL2N,
                               GRAND_LAST_LAYER, BN_GRAD_NORM, CONV_GRAD_NORM_CATDOT,
                               CONV_BWD_GRAD_NORM)}


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def mode_counts() -> dict[str, dict[str, int]]:
    """Launches by mode, for each kernel that has modes."""
    return {name: dict(k.mode_launches) for name, k in KERNELS.items() if k.mode_launches}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
        k.mode_launches = dict.fromkeys(k.mode_launches, 0)


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


def direct_mma_plan(out_hw, kernel_size, strides) -> dict | None:
    """The direct kernel's tensor-core staging plan (``mma_plan`` in
    conv_norm_mma.cuh), or None where even one output position per chunk
    does not fit: the output map in chunks of ``rows`` × ``cols`` positions,
    each staging its input band (``band_h`` × ``band_w``; ``in_dy`` input rows
    per band row and ``out_dy`` band rows per output row, likewise across) and
    ``g_rows`` cotangent rows, in a ring of ``DIRECT_MMA_STAGES`` buffers
    within ``DIRECT_MMA_MAX_SMEM`` (``smem`` bytes). A kernel dimension of
    width 1 stages only the input lines its stride samples."""
    ho, wo = out_hw
    (kh, kw), (sy, sx) = kernel_size, strides
    cols = min(wo, DIRECT_MMA_MAX_COLS)
    rows = min(ho, max(1, DIRECT_MMA_CHUNK // cols))
    while True:
        band_h = rows if kh == 1 else (rows - 1) * sy + kh
        band_w = cols if kw == 1 else (cols - 1) * sx + kw
        g_rows = -(-rows * cols // 16) * 16
        stage_rows = band_h * band_w + g_rows
        smem = (DIRECT_MMA_STAGES * stage_rows + 1) * DIRECT_MMA_ROW_BYTES
        if smem <= DIRECT_MMA_MAX_SMEM:
            return {"rows": rows, "cols": cols, "band_h": band_h, "band_w": band_w,
                    "in_dy": sy if kh == 1 else 1, "in_dx": sx if kw == 1 else 1,
                    "out_dy": 1 if kh == 1 else sy, "out_dx": 1 if kw == 1 else sx,
                    "g_rows": g_rows, "chunks_r": -(-ho // rows),
                    "chunks_q": -(-wo // cols), "stage_rows": stage_rows, "smem": smem}
        if rows > 1:
            rows -= 1
        elif cols > 1:
            cols = -(-cols // 2)
        else:
            return None


def _direct_mma_block_groups(kernel_size) -> int:
    """Tensor-core blocks per example and C×K tile: one warpgroup per group of
    ``DIRECT_MMA_OFFSETS`` offsets, up to ``DIRECT_MMA_GROUPS`` in a block."""
    groups = -(-kernel_size[0] * kernel_size[1] // DIRECT_MMA_OFFSETS)
    return -(-groups // min(groups, DIRECT_MMA_GROUPS))


def direct_partials(c: int, k: int, kernel_size, dtype: torch.dtype) -> int:
    """Partials per example of one direct launch, one per block: per offset
    (fp32 mode) or per block of offset groups (tensor-core mode), times the C
    and K tiles."""
    kh, kw = kernel_size
    per = kh * kw if DIRECT_MODES[dtype] == "fp32" else _direct_mma_block_groups(kernel_size)
    return per * -(-c // DIRECT_TILE) * -(-k // DIRECT_TILE)


def conv_grad_norm_direct_fits(x_shape, g_shape, kernel_size, strides) -> bool:
    """Whether the direct kernel takes this layer in either mode: fp32 with
    offsets on grid.y and C×K tiles on grid.z within CUDA's limits;
    tensor-core with a staging plan and its one-dimensional grid (B × block
    groups × tiles blocks) within CUDA's limit. Both modes stream S in chunks,
    so no map size is too large."""
    kh, kw = kernel_size
    tiles = -(-x_shape[-1] // DIRECT_TILE) * -(-g_shape[-1] // DIRECT_TILE)
    blocks = x_shape[0] * _direct_mma_block_groups(kernel_size) * tiles
    return (kh * kw <= _GRID_YZ_MAX and tiles <= _GRID_YZ_MAX
            and blocks <= _GRID_X_MAX
            and direct_mma_plan(g_shape[1:3], kernel_size, strides) is not None)


def conv_grad_norm_v2_eligible(x_shape, g_shape, kernel_size, strides,
                               padding) -> bool:
    """The v2 entry: unit stride, and an output map of at most
    ``MAX_RESIDENT_S`` positions, so the fp32 mode's [S, 64] cotangent tile
    stays resident in shared memory (64 KB) across every kernel offset (the
    tensor-core mode would take any S)."""
    del padding
    if tuple(strides) != (1, 1):
        return False
    s = g_shape[1] * g_shape[2]
    return s <= MAX_RESIDENT_S and conv_grad_norm_direct_fits(
        x_shape, g_shape, kernel_size, strides)


def gram_plan(hw: int, s: int, c: int, k: int, dtype: torch.dtype) -> dict | None:
    """The Gram kernel's block layout (``gram_plan`` in conv_grad_norm_gram.cu)
    for ``hw`` input and ``s`` output positions and C, K channels of ``dtype``,
    or None where it does not fit: both position counts padded to a multiple
    of 16 (``hwp``, ``sp``; ``rows`` = hwp + sp staged rows per example), the
    widest ``chunk`` of channels staged per step (the whole row first, then
    halves, in units of ``GRAM_UNIT_BYTES``; ``nsteps`` of them through a ring
    of ``stages`` = min(``GRAM_STAGES``, nsteps) buffers) with the most
    ``examples`` (4, 2) within ``GRAM_BLOCK_SMEM``; at the narrowest chunk
    also one example, within ``GRAM_BLOCK_SMEM`` or else ``GRAM_MAX_SMEM``
    (``smem`` bytes: the ring of rows, each padded by ``GRAM_ROW_PAD``, and
    the fp32 Grams)."""
    item = torch.tensor([], dtype=dtype).element_size()
    hwp, sp = -(-hw // 16) * 16, -(-s // 16) * 16
    rows, unit = hwp + sp, GRAM_UNIT_BYTES // item
    depth = -(-max(c, k) // unit) * unit
    chunk = depth
    while True:
        nsteps = -(-depth // chunk)
        stages = min(GRAM_STAGES, nsteps)
        last = chunk == unit
        e = GRAM_EXAMPLES
        while e >= 1:
            smem = (stages * e * rows * (chunk * item + GRAM_ROW_PAD)
                    + e * (hwp * hwp + sp * sp) * 4)
            if ((smem <= GRAM_BLOCK_SMEM and (e > 1 or last))
                    or (last and e == 1 and smem <= GRAM_MAX_SMEM)):
                return {"hwp": hwp, "sp": sp, "rows": rows, "examples": e, "chunk": chunk,
                        "nsteps": nsteps, "stages": stages, "smem": smem}
            e //= 2
        if last:
            return None
        chunk = -(-(chunk // 2) // unit) * unit


def conv_grad_norm_gram_eligible(x_shape, g_shape, kernel_size, strides,
                                 padding) -> bool:
    """The Gram kernel: unit stride, and a block layout (``gram_plan``) in both
    dtypes, so the route does not depend on the dtype."""
    del kernel_size, padding
    if tuple(strides) != (1, 1):
        return False
    hw, s = x_shape[1] * x_shape[2], g_shape[1] * g_shape[2]
    return all(gram_plan(hw, s, x_shape[-1], g_shape[-1], dtype) is not None
               for dtype in _DTYPE_CODE)


def gll_plan(features: int, classes: int, dtype: torch.dtype) -> dict:
    """The last-layer kernel's block layout (``launch`` in grand_last_layer.cu)
    for F ``features`` of ``dtype`` and C ``classes``: a tile of ``rows``
    (``GLL_ROWS``) rows and one split of ``classes`` (32, or
    ``GLL_MAX_CLASSES`` above 32) per block, ``splits`` of them covering the C
    classes, F in ``chunks`` of ``GLL_CHUNK`` through a ring of ``GLL_STAGES``
    buffers (``smem`` bytes with two buffers of split operands, the rows'
    ‖h‖² and the two class halves' sums). A function of (F, C, dtype) alone,
    so a row's arithmetic never depends on the batch."""
    nc = 32 if classes <= 32 else GLL_MAX_CLASSES
    bf16 = dtype == torch.bfloat16
    stage = GLL_ROWS * (GLL_ROW_BYTES if bf16 else 4 * GLL_CHUNK) + nc * 4 * GLL_CHUNK
    parts = (3 * nc + (1 if bf16 else 3) * GLL_ROWS) * GLL_ROW_BYTES
    smem = GLL_STAGES * stage + 2 * parts + 4 * GLL_ROWS + 2 * 16 * GLL_ROWS
    return {"rows": GLL_ROWS, "classes": nc, "splits": -(-classes // nc),
            "chunk": GLL_CHUNK, "chunks": -(-features // GLL_CHUNK), "stages": GLL_STAGES,
            "smem": smem}


@functools.lru_cache(maxsize=None)
def grand_last_layer_eligible(features: int, classes: int) -> bool:
    """The last-layer kernel streams F through its ring and splits C across
    blocks, so it takes any F, C ≥ 1 whose layout fits a block's shared
    memory in both dtypes (every one does: at most 207 KB)."""
    return features >= 1 and classes >= 1 and all(
        gll_plan(features, classes, dtype)["smem"] <= MAX_BLOCK_SMEM for dtype in _DTYPE_CODE)


def el2n_plan(classes: int) -> dict:
    """The EL2N kernel's layout (``launch`` in el2n.cu) for C ``classes``:
    ``lanes`` per row (the power of two covering C / 2, at most 32), so
    ``rows_per_warp`` rows share a warp; ``values`` logits per lane per tile
    (a power of two from 2 to ``EL2N_MAX_VALUES``) and ``tiles`` of
    lanes × values logits per row."""
    lanes = min(32, 1 << max(0, ((classes + 1) // 2 - 1).bit_length()))
    values = min(EL2N_MAX_VALUES, max(2, 1 << (-(-classes // lanes) - 1).bit_length()))
    return {"lanes": lanes, "rows_per_warp": 32 // lanes, "values": values,
            "tiles": -(-classes // (lanes * values))}


def bn_grad_norm_eligible(x_shape) -> bool:
    """The stacked-BN kernel takes 4-D (NHWC) activations of any size (one
    block per row; the scalar mode takes any channel count)."""
    return len(x_shape) == 4


def bn_vector_plan(c: int, dtype: torch.dtype) -> dict | None:
    """The stacked-BN kernel's vector-mode thread layout for C channels, or
    None where the mode does not take C: ``vec`` channels per 16-byte load
    (8 bf16, 4 fp32), ``channel_vectors`` = C / vec threads across and
    ``groups`` = ``BN_THREADS`` // channel_vectors position groups down
    (C a multiple of vec, at most ``BN_THREADS`` vectors)."""
    vec = 16 // torch.tensor([], dtype=dtype).element_size()
    if c % vec or c // vec > BN_THREADS:
        return None
    return {"vec": vec, "channel_vectors": c // vec, "groups": BN_THREADS // (c // vec)}


def bn_mode(xs, gs) -> str:
    """The stacked-BN mode a launch of these layers takes: ``vector`` where
    ``bn_vector_plan`` takes C and every layer's x and g start 16-byte
    aligned, else ``scalar``."""
    x0 = xs[0]
    aligned = all(t.data_ptr() % 16 == 0 for t in (*xs, *gs))
    return ("vector" if aligned and bn_vector_plan(x0.shape[-1], x0.dtype) is not None
            else "scalar")


def catdot_mma_plan(out_hw, kernel_size) -> dict | None:
    """The cat-dot kernel's tensor-core staging plan (``catdot_plan`` in
    conv_grad_norm_catdot.cu), or None where even one position per chunk does
    not fit: the padded Ho × Wp grid (Wp = Wo + kw − 1) in chunks of ``rows``
    × ``cols`` positions, each staging an x band of the rows the kh row shifts
    read (``xband`` rows: (rows + kh − 1) × cols) and a g band of its rows with
    a (kw − 1)-column halo (rows × ``gband_w``), in a ring of
    ``DIRECT_MMA_STAGES`` buffers within ``DIRECT_MMA_MAX_SMEM``."""
    ho, wp = out_hw[0], out_hw[1] + kernel_size[1] - 1
    kh, kw = kernel_size
    cols = min(wp, DIRECT_MMA_MAX_COLS)
    rows = min(ho, max(1, DIRECT_MMA_CHUNK // cols))
    while True:
        xband, gband_w = (rows + kh - 1) * cols, cols + kw - 1
        stage_rows = xband + rows * gband_w
        smem = (DIRECT_MMA_STAGES * stage_rows + 1) * DIRECT_MMA_ROW_BYTES
        if smem <= DIRECT_MMA_MAX_SMEM:
            return {"rows": rows, "cols": cols, "xband": xband, "gband_w": gband_w,
                    "chunks_r": -(-ho // rows), "chunks_q": -(-wp // cols),
                    "stage_rows": stage_rows, "smem": smem}
        if rows > 1:
            rows -= 1
        elif cols > 1:
            cols = -(-cols // 2)
        else:
            return None


def _catdot_block_groups(kernel_size) -> int:
    """Tensor-core cat-dot blocks per example and C×K tile: one warpgroup per
    (column shift, group of up to 3 row shifts), up to ``DIRECT_MMA_GROUPS``
    in a block."""
    kh, kw = kernel_size
    groups = kw * -(-kh // DIRECT_MMA_OFFSETS)
    return -(-groups // min(groups, DIRECT_MMA_GROUPS))


def catdot_partials(c: int, k: int, kernel_size, dtype: torch.dtype) -> int:
    """Partials per example of one cat-dot launch, one per block: per 64×64
    tile of the [kh·C, kw·K] product (fp32 mode) or per block of offset
    groups and C×K tile (tensor-core mode)."""
    kh, kw = kernel_size
    if DIRECT_MODES[dtype] == "fp32":
        return -(-kh * c // DIRECT_TILE) * -(-kw * k // DIRECT_TILE)
    return _catdot_block_groups(kernel_size) * -(-c // DIRECT_TILE) * -(-k // DIRECT_TILE)


def conv_grad_norm_catdot_eligible(x_shape, g_shape, kernel_size, strides,
                                   padding) -> bool:
    """The cat-dot kernel. Kept from the JAX package's ``_catdot_ok`` as
    properties of the algorithm: unit stride, a multi-offset kernel
    (kh·kw ≥ 2) and at least 128 contraction rows (Ho·Wp, Wp = Wo + kw − 1).
    Kept from it for now, to re-measure on the card: C and K multiples of 128
    (on the TPU the lane concatenations relayout otherwise), so ResNet-18
    routes exactly the layers JAX routes. Hopper's own: the fp32 mode's
    [kh·C, kw·K] tile grid within grid.y, and the tensor-core mode's staging
    plan (``catdot_mma_plan``) and one-dimensional grid within CUDA's limit.
    The TPU's VMEM budget has no counterpart: both modes stream the
    contraction in chunks."""
    del padding
    if tuple(strides) != (1, 1):
        return False
    kh, kw = kernel_size
    b, c, (ho, wo, k) = x_shape[0], x_shape[-1], g_shape[1:]
    if kh * kw < 2 or ho * (wo + kw - 1) < 128 or c % 128 or k % 128:
        return False
    tiles = -(-kh * c // DIRECT_TILE) * -(-kw * k // DIRECT_TILE)
    return (tiles <= _GRID_YZ_MAX and b * _catdot_block_groups(kernel_size) <= _GRID_X_MAX
            and catdot_mma_plan((ho, wo), kernel_size) is not None)


def mega_dx_plan(batch: int, in_hw, kernel_size) -> dict | None:
    """The megakernel's tensor-core dx tiling (``dx_plan`` in
    conv_bwd_grad_norm.cu), or None where even one position does not fit (a
    kernel of more than about 13 offsets) or the grid would outgrow CUDA's
    limit. Each warpgroup owns a tile of ``rows`` × ``cols`` input positions
    (at most 64·``mt``: 128 positions, or 64 on maps of at most 64), staging
    a cotangent band of ``band_h`` × ``band_w`` positions per K chunk beside
    the chunk's hi/lo weight rows (``w_rows``), in a ring of
    ``DIRECT_MMA_STAGES`` buffers within ``MEGA_DX_MAX_SMEM``; ``bpc`` dx
    blocks of three tiles each per C tile."""
    h, w = in_hw
    kh, kw = kernel_size
    mt = 2 if h * w > 64 else 1
    cols = min(w, MEGA_DX_MAX_COLS)
    rows = min(h, max(1, 64 * mt // cols))
    while True:
        band_h, band_w = rows + kh - 1, cols + kw - 1
        w_rows = 2 * kh * kw * MEGA_DX_K
        stage_bytes = (w_rows * DIRECT_MMA_ROW_BYTES
                       + DIRECT_MMA_GROUPS * band_h * band_w * MEGA_DX_ROW_BYTES)
        smem = DIRECT_MMA_STAGES * stage_bytes + DIRECT_MMA_ROW_BYTES
        if smem <= MEGA_DX_MAX_SMEM:
            tiles_q = -(-w // cols)
            ptiles = -(-h // rows) * tiles_q
            if batch * ptiles > _GRID_X_MAX:
                return None
            return {"mt": mt, "rows": rows, "cols": cols, "band_h": band_h,
                    "band_w": band_w, "tiles_q": tiles_q, "ptiles": ptiles,
                    "bpc": -(-batch * ptiles // DIRECT_MMA_GROUPS), "w_rows": w_rows,
                    "smem": smem}
        if rows > 1:
            rows -= 1
        elif cols > 1:
            cols = -(-cols // 2)
        else:
            return None


def mega_partials(c: int, k: int, kernel_size, dtype: torch.dtype) -> int:
    """Partials per example of one megakernel launch: the direct kernel's in
    the tensor-core mode (its norm role is that walk); none in the fp32 mode,
    whose norm blocks own a whole example."""
    if DIRECT_MODES[dtype] == "fp32":
        return 0
    return direct_partials(c, k, kernel_size, dtype)


def conv_bwd_grad_norm_eligible(x_shape, g_shape, kernel_size, strides) -> bool:
    """The megakernel: unit stride (the strided entry and projection convs
    keep the two-phase contraction, as on the TPU); the tensor-core mode's
    norm plan (``direct_mma_plan``) and dx plan (``mega_dx_plan``, whose
    weight staging bounds the kernel size); and each mode's one-dimensional
    grid within CUDA's limit (fp32: B norm blocks, then B·⌈H·W/64⌉·⌈C/64⌉ dx
    blocks; tensor cores: B·(offset-group blocks) norm blocks, then
    ⌈C/64⌉·``bpc`` dx blocks)."""
    if tuple(strides) != (1, 1):
        return False
    b, h, w, c = x_shape
    dx = mega_dx_plan(b, (h, w), kernel_size)
    if dx is None or not conv_grad_norm_direct_fits(x_shape, g_shape, kernel_size, (1, 1)):
        return False
    ctiles = -(-c // DIRECT_TILE)
    blocks_fp32 = b * (1 + -(-h * w // DIRECT_TILE) * ctiles)
    blocks_mma = b * _direct_mma_block_groups(kernel_size) + ctiles * dx["bpc"]
    return max(blocks_fp32, blocks_mma) <= _GRID_X_MAX


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


def grand_last_layer_plain(features, weight, bias, labels, mask) -> torch.Tensor:
    """Plain version of the last-layer GraNd kernel: the classifier in fp32
    (``weight`` [C, F] as ``nn.Linear`` holds it), then the score."""
    logits = torch.nn.functional.linear(features.float(), weight.float(), bias.float())
    probs = torch.softmax(logits, dim=-1)
    onehot = torch.nn.functional.one_hot(labels.long(), logits.shape[-1]).float()
    err = probs - onehot
    feat_sq = (features.float() ** 2).sum(dim=-1)
    return torch.sqrt((err * err).sum(dim=-1) * (feat_sq + 1.0)) * mask.float()


def bn_grad_norm_sq_plain(xs, gs, stats, use_scale: bool = True,
                          use_bias: bool = True) -> torch.Tensor:
    """Plain version of the stacked-BN kernel: per layer ``l``, the channel
    reductions Σ_s g·x and Σ_s g in fp32 and the eval-BN terms with
    ``stats[l] = (mean, rstd)``; the layers' [B] results concatenated."""
    outs = []
    for layer, (x, g) in enumerate(zip(xs, gs)):
        b, c = x.shape[0], x.shape[-1]
        gf = g.float().reshape(b, -1, c)
        gx = (gf * x.float().reshape(b, -1, c)).sum(dim=1)
        gsum = gf.sum(dim=1)
        out = torch.zeros(b, dtype=torch.float32, device=x.device)
        if use_scale:
            mean, rstd = stats[layer, 0].float(), stats[layer, 1].float()
            out = out + (((gx - mean * gsum) * rstd) ** 2).sum(dim=-1)
        if use_bias:
            out = out + (gsum * gsum).sum(dim=-1)
        outs.append(out)
    return torch.cat(outs)


def conv_grad_norm_sq_catdot_plain(x, g, kernel_size, padding) -> torch.Tensor:
    """Plain version of the cat-dot kernel: A [B, Ho·Wp, kh·C] from the kh
    row-shifted windows of padded x, G [B, Ho·Wp, kw·K] from the kw
    column-shifted zero-embedded copies of g (Wp = Wo + kw − 1), and
    ‖AᵀG‖²_F in fp32. Unit stride; no bias term."""
    kh, kw = kernel_size
    (pt, _pb), (pl, _pr) = padding
    b, h, w, c = x.shape
    _, ho, wo, k = g.shape
    wp = wo + kw - 1
    xp = torch.nn.functional.pad(x.float(), (0, 0, pl, wp - w - pl, pt,
                                             ho + kh - 1 - h - pt))
    a = torch.cat([xp[:, oy:oy + ho] for oy in range(kh)], dim=-1)
    gf = g.float()
    gcat = torch.cat([torch.nn.functional.pad(gf, (0, 0, ox, wp - wo - ox))
                      for ox in range(kw)], dim=-1)
    m = torch.bmm(a.reshape(b, ho * wp, kh * c).transpose(1, 2),
                  gcat.reshape(b, ho * wp, kw * k))
    return (m * m).sum(dim=(1, 2))


def conv_bwd_grad_norm_sq_plain(x, g, weight, kernel_size, padding,
                                use_bias: bool = False):
    """Plain version of the megakernel: ``dx`` [B, H, W, C] in x's dtype as
    the transposed conv of g with ``weight`` ([K, C, kh, kw], fp32), cropped
    to the unpadded input, and the direct plain version's ‖∂W‖² (+ bias)."""
    (pt, _pb), (pl, _pr) = padding
    _, h, w, _ = x.shape
    dx_pad = torch.nn.functional.conv_transpose2d(g.float().permute(0, 3, 1, 2),
                                                  weight.float())
    dx = dx_pad[:, :, pt:pt + h, pl:pl + w].permute(0, 2, 3, 1)
    norm = conv_grad_norm_sq_plain(x, g, kernel_size, (1, 1), padding,
                                   use_bias=use_bias)
    return dx.to(x.dtype).contiguous(), norm


# ---------------------------------------------------------------- wrappers


def _direct_launch(x, g, kernel_size, strides, padding, use_bias, resident,
                   name) -> torch.Tensor:
    _check_contiguous(name, x, g)
    (kh, kw), (sy, sx) = kernel_size, strides
    (pt, _pb), (pl, _pr) = padding
    b, h, w, c = x.shape
    _, ho, wo, k = g.shape
    n_partials = direct_partials(c, k, kernel_size, x.dtype)
    partials = torch.empty((b, n_partials), dtype=torch.float32, device=x.device)
    out = torch.empty(b, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        CONV_GRAD_NORM_DIRECT.launch(
            x.data_ptr(), g.data_ptr(), partials.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[x.dtype], b, h, w, c, ho, wo, k, kh, kw, sy, sx, pt, pl,
            n_partials, int(use_bias), int(resident), _stream(x),
            mode=DIRECT_MODES[x.dtype])
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
            b, h, w, c, ho, wo, k, kh, kw, pt, pl, int(use_bias), _stream(x),
            mode=DIRECT_MODES[x.dtype])
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
    # The kernel reads bf16 or fp32 logits and int64 or int32 labels as they are:
    # under half precision a call launches the kernel and nothing else.
    z = (logits if logits.dtype in _DTYPE_CODE else logits.float()).contiguous()
    y = _labels(labels)
    m = mask.float().contiguous()
    b, c = z.shape
    out = torch.empty(b, dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        EL2N.launch(z.data_ptr(), _DTYPE_CODE[z.dtype], y.data_ptr(),
                    int(y.dtype == torch.int64), m.data_ptr(), out.data_ptr(), b, c,
                    _stream(z))
    return out


def _labels(labels: torch.Tensor) -> torch.Tensor:
    """Labels as the kernels read them: int64 or int32 as given, others as int64."""
    y = labels if labels.dtype in (torch.int64, torch.int32) else labels.long()
    return y.contiguous()


#: Per-device row-tile tickets of the last-layer kernel (zero between launches:
#: the last block of each tile resets its own). Grown, never freed while a
#: captured CUDA graph may still point at an older buffer.
_GLL_TICKETS: dict = {}


def _gll_tickets(device: torch.device, tiles: int) -> torch.Tensor:
    held = _GLL_TICKETS.setdefault(device, [])
    if not held or held[-1].numel() < tiles:
        held.append(torch.zeros(max(tiles, 64), dtype=torch.int32, device=device))
    return held[-1]


def grand_last_layer(features: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, labels: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """Last-layer GraNd [B] from features [B, F] and the classifier
    (``weight`` [C, F], ``bias`` [C]), the classifier product computed by the
    kernel to fp32 accuracy (bf16 or fp32 features read as they are, the fp32
    weight split into three bf16 parts inside the kernel). One launch; with
    more than one class split (``gll_plan``) launches on one device take turns
    on its tickets, so they must not run concurrently on two streams."""
    name = "grand_last_layer"
    b, f = features.shape[0], features.shape[-1]
    if features.dim() != 2 or weight.dim() != 2 or weight.shape[1] != f \
            or bias.shape != weight.shape[:1] or labels.shape != (b,) \
            or mask.shape != (b,):
        raise ValueError(f"{name}: want features [B, F], weight [C, F], bias [C], "
                         f"labels [B], mask [B]; got {tuple(features.shape)}, "
                         f"{tuple(weight.shape)}, {tuple(bias.shape)}, "
                         f"{tuple(labels.shape)}, {tuple(mask.shape)}")
    if not _on_cuda(features, name):
        return grand_last_layer_plain(features, weight, bias, labels, mask)
    if any(t.device != features.device for t in (weight, bias, labels, mask)):
        raise ValueError(f"{name}: every input must share the features' device")
    c = weight.shape[0]
    if not grand_last_layer_eligible(f, c):
        raise ValueError(f"{name}: caller must check grand_last_layer_eligible")
    h = (features if features.dtype in _DTYPE_CODE else features.float()).contiguous()
    w = weight.float().contiguous()     # nn.Linear's own [C, F]: no copy
    bb = bias.float().contiguous()
    y = _labels(labels)
    m = mask.float().contiguous()
    out = torch.empty(b, dtype=torch.float32, device=h.device)
    plan = gll_plan(f, c, h.dtype)
    partials = tickets = None
    if plan["splits"] > 1:
        partials = torch.empty((b, plan["splits"], 4), dtype=torch.float32, device=h.device)
        tickets = _gll_tickets(h.device, -(-b // plan["rows"]))
    with torch.cuda.device(h.device):
        GRAND_LAST_LAYER.launch(
            h.data_ptr(), _DTYPE_CODE[h.dtype], w.data_ptr(), bb.data_ptr(), y.data_ptr(),
            int(y.dtype == torch.int64), m.data_ptr(), out.data_ptr(),
            None if partials is None else partials.data_ptr(),
            None if tickets is None else tickets.data_ptr(), b, f, c, _stream(h))
    return out


def bn_grad_norm_sq(xs, gs, stats: torch.Tensor, use_scale: bool = True,
                    use_bias: bool = True) -> torch.Tensor:
    """[L·B] ⟵ eval-mode BatchNorm per-example grad-norm² of L same-shape
    layers: ``xs[l]``, ``gs[l]`` are layer l's NHWC input and output cotangent
    [B, H, W, C], ``stats`` [L, 2, C] its (mean, rstd) rows. Row
    ``l·B + i`` is layer l's example i. The layers are not concatenated: the
    kernel takes an array of their base pointers. The launch takes the mode
    ``bn_mode`` names, and is counted under it."""
    name = "bn_grad_norm_sq"
    n = len(xs)
    if n == 0 or len(gs) != n or tuple(stats.shape) != (n, 2, xs[0].shape[-1]):
        raise ValueError(f"{name}: want L layers of x and g and stats [L, 2, C]; got "
                         f"{n}, {len(gs)} and {tuple(stats.shape)}")
    for x, g in zip(xs, gs):
        _check_pair(x, g, name)
        if x.shape != xs[0].shape or g.shape != x.shape or x.dtype != xs[0].dtype \
                or x.device != xs[0].device:
            raise ValueError(f"{name}: every layer must share one shape, dtype and device")
    if not _on_cuda(xs[0], name):
        return bn_grad_norm_sq_plain(xs, gs, stats, use_scale, use_bias)
    _check_contiguous(name, *xs, *gs)
    b, h, w, c = xs[0].shape
    mode = bn_mode(xs, gs)
    st = stats.to(device=xs[0].device, dtype=torch.float32).contiguous()
    out = torch.empty(n * b, dtype=torch.float32, device=xs[0].device)
    with torch.cuda.device(xs[0].device):
        for l0 in range(0, n, BN_MAX_LAYERS):
            ls = range(l0, min(n, l0 + BN_MAX_LAYERS))
            xp = (ctypes.c_void_p * len(ls))(*[xs[i].data_ptr() for i in ls])
            gp = (ctypes.c_void_p * len(ls))(*[gs[i].data_ptr() for i in ls])
            BN_GRAD_NORM.launch(xp, gp, st[l0].data_ptr(), out[l0 * b].data_ptr(),
                                _DTYPE_CODE[xs[0].dtype], len(ls), b, h * w, c,
                                int(use_scale), int(use_bias), int(mode == "vector"),
                                _stream(xs[0]), mode=mode)
    return out


def conv_grad_norm_sq_catdot(x: torch.Tensor, g: torch.Tensor, kernel_size,
                             padding) -> torch.Tensor:
    """[B] ⟵ ‖per-example conv weight gradient‖²_F in cat-dot form, unit
    stride, raw unpadded ``x``. The bias term is the caller's, as in the JAX
    package's ``catdot=True`` route."""
    name = "conv_grad_norm_sq_catdot"
    _check_pair(x, g, name)
    _check_geometry(x, g, kernel_size, (1, 1), padding, name)
    if not conv_grad_norm_catdot_eligible(x.shape, g.shape, kernel_size, (1, 1),
                                          padding):
        raise ValueError(f"{name}: caller must check conv_grad_norm_catdot_eligible")
    if not _on_cuda(x, name):
        return conv_grad_norm_sq_catdot_plain(x, g, kernel_size, padding)
    _check_contiguous(name, x, g)
    kh, kw = kernel_size
    (pt, _pb), (pl, _pr) = padding
    b, h, w, c = x.shape
    _, ho, wo, k = g.shape
    n_partials = catdot_partials(c, k, kernel_size, x.dtype)
    partials = torch.empty((b, n_partials), dtype=torch.float32, device=x.device)
    out = torch.empty(b, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        CONV_GRAD_NORM_CATDOT.launch(
            x.data_ptr(), g.data_ptr(), partials.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[x.dtype], b, h, w, c, ho, wo, k, kh, kw, pt, pl, n_partials,
            _stream(x), mode=DIRECT_MODES[x.dtype])
    return out


def conv_bwd_grad_norm_sq(x: torch.Tensor, g: torch.Tensor, weight: torch.Tensor,
                          kernel_size, padding, use_bias: bool = False):
    """``(dx [B, H, W, C] in x's dtype, norm² [B] fp32)`` of a unit-stride
    conv from one launch: the input cotangent of the conv with ``weight``
    (PyTorch's [K, C, kh, kw], fp32) and the per-example ‖∂W‖²_F (+ the bias
    term when ``use_bias``)."""
    name = "conv_bwd_grad_norm_sq"
    _check_pair(x, g, name)
    _check_geometry(x, g, kernel_size, (1, 1), padding, name)
    kh, kw = kernel_size
    b, h, w, c = x.shape
    _, ho, wo, k = g.shape
    if tuple(weight.shape) != (k, c, kh, kw):
        raise ValueError(f"{name}: weight {tuple(weight.shape)} is not [K, C, kh, kw] = "
                         f"{(k, c, kh, kw)}")
    if not conv_bwd_grad_norm_eligible(x.shape, g.shape, kernel_size, (1, 1)):
        raise ValueError(f"{name}: caller must check conv_bwd_grad_norm_eligible")
    if not _on_cuda(x, name):
        return conv_bwd_grad_norm_sq_plain(x, g, weight, kernel_size, padding,
                                           use_bias=use_bias)
    if weight.device != x.device:
        raise ValueError(f"{name}: weight on {weight.device} but x on {x.device}")
    _check_contiguous(name, x, g)
    # [K, kh, kw, C]: the channels_last memory of the conv weight, a view.
    wk = weight.float().permute(0, 2, 3, 1)
    if x.dtype == torch.bfloat16:
        # The tensor-core mode takes the weight as a bf16 pair [2, K, kh, kw, C]
        # (w_hi = bf16(w), w_lo = bf16(w − w_hi)), split once per launch.
        hi = wk.to(torch.bfloat16)
        wk = torch.stack((hi, (wk - hi.float()).to(torch.bfloat16)))
    wk = wk.contiguous()
    (pt, _pb), (pl, _pr) = padding
    n_partials = mega_partials(c, k, kernel_size, x.dtype)
    partials = torch.empty((b, n_partials), dtype=torch.float32, device=x.device)
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    out = torch.empty(b, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        CONV_BWD_GRAD_NORM.launch(
            x.data_ptr(), g.data_ptr(), wk.data_ptr(), dx.data_ptr(), partials.data_ptr(),
            out.data_ptr(), _DTYPE_CODE[x.dtype], b, h, w, c, ho, wo, k, kh, kw, pt, pl,
            n_partials, int(use_bias), _stream(x), mode=DIRECT_MODES[x.dtype])
    return dx, out
