"""Batched exact GraNd: per-example gradient norms without per-example backwards.

Counterpart of ``data_diet_distributed_tpu/ops/grand_batched.py``
(``batched_grand_scores``, the two-phase algorithm): ‖∇_θ ℓ(f(x_i), y_i)‖₂
over all parameters from ONE batched forward and ONE batched backward.

1. A forward hook on every Conv/Linear/BatchNorm captures the layer input ``x``
   and output ``y``. One ``torch.autograd.grad`` of Σ CE·mask w.r.t. the
   outputs ``[y_1..y_L]`` gives each layer's per-example cotangent ``g``. The
   model runs on plain variable tensors (``functional_call``) with only the
   image requiring grad, so no weight gradient is ever formed.
2. Each layer's per-example weight-gradient norm has a closed form in ``x``
   and ``g``: Dense ``‖x‖²‖g‖²``; Conv ``‖P_iᵀ G_i‖²_F`` (direct, cat-dot or
   Gram form, through the hand-written kernels on the card —
   ``ops/kernels.py``); eval-mode BatchNorm from two channel reductions (or
   the stacked-BN kernel).

``batched_grand_scores_fused`` computes the same quantity with each layer's
contraction inside the backward pass (``torch.autograd.Function`` taps), and
with ``megakernel`` lets one kernel launch produce both an eligible conv's
input cotangent and its contraction.

Composition toggles are the JAX package's, read from the same ``DDT_GRAND_*``
environment variables when the module is imported (one environment selects
the same program in either package) and patchable as module attributes.

Exactness needs eval-mode BatchNorm; grouped and dilated convs, padding modes
other than zeros, modules applied twice per forward and parameters outside
Conv/Linear/BatchNorm are refused loudly.
"""

from __future__ import annotations

import os
from collections import Counter

import torch
import torch.nn as nn
from torch.func import functional_call

from . import kernels

_F32 = torch.float32
_HOOKED = (nn.modules.conv._ConvNd, nn.Linear, nn.modules.batchnorm._BatchNorm)

# Prefer the direct form over the Gram form while its FLOPs are within this
# factor of Gram's. The value is the JAX package's, measured on a TPU; to
# re-measure on the card.
_DIRECT_OVER_GRAM_MAX_RATIO = 8.0

_TOGGLE_TRUE = frozenset(("1", "true", "on", "yes"))
_TOGGLE_FALSE = frozenset(("0", "false", "off", "no", ""))


def _toggle(name: str, default: bool) -> bool:
    """A ``DDT_GRAND_*`` switch from the environment; a value that is neither
    true nor false raises, so a typo never silently selects a program."""
    v = os.environ.get(name)
    if v is None:
        return default
    s = v.strip().lower()
    if s in _TOGGLE_TRUE:
        return True
    if s in _TOGGLE_FALSE:
        return False
    raise ValueError(f"{name}={v!r}: expected one of "
                     f"{sorted(_TOGGLE_TRUE | _TOGGLE_FALSE)}")


# Two-phase route: score same-geometry convs (GROUP_CONV) / BatchNorms
# (GROUP_BN) as one batch-concatenated group; BatchNorm through the stacked-BN
# kernel (USE_BN_KERNEL); 128-aligned deep-contraction convs through the
# cat-dot kernel (USE_CATDOT); convs with a patch width below 32 (the 3-channel
# stem) on the plain route (STEM_XLA, the JAX name of that gate).
GROUP_CONV = _toggle("DDT_GRAND_GROUP_CONV", False)
GROUP_BN = _toggle("DDT_GRAND_GROUP_BN", False)
USE_BN_KERNEL = _toggle("DDT_GRAND_BN_KERNEL", False)
USE_CATDOT = _toggle("DDT_GRAND_CATDOT", False)
STEM_XLA = _toggle("DDT_GRAND_STEM_XLA", True)
# Fused route: contractions inside the backward (batched_grand_scores_fused),
# with MEGAKERNEL eligible convs' backward and contraction in one launch.
FUSED_BWD = _toggle("DDT_GRAND_FUSED", False)
MEGAKERNEL = _toggle("DDT_GRAND_MEGAKERNEL", False)

#: Patch width (kh·kw·C) below which a conv (the 3-channel stem) is left to the
#: plain route: by STEM_XLA on the two-phase route, always on the megakernel's.
_STEM_PATCH_MIN = 32


def _canon_padding(padding):
    if isinstance(padding, str):
        return padding
    return tuple((p, p) if isinstance(p, int) else tuple(p) for p in padding)


def _record_for(path: str, mod: nn.Module) -> dict:
    """Static per-layer metadata needed to rebuild the weight-grad norm."""
    if isinstance(mod, nn.modules.conv._ConvNd):
        if not isinstance(mod, nn.Conv2d) or mod.transposed:
            raise NotImplementedError(
                f"batched GraNd supports 2-D convolutions only (module {path} is "
                f"{type(mod).__name__}); use the grand_vmap score method")
        if mod.groups != 1:
            raise NotImplementedError(
                "batched GraNd supports groups=1 convolutions only "
                f"(module {path}); use the grand_vmap score method")
        if tuple(mod.dilation) != (1, 1):
            raise NotImplementedError(
                f"batched GraNd does not support dilated convolutions "
                f"(module {path}); use the grand_vmap score method")
        if mod.padding_mode != "zeros":
            raise NotImplementedError(
                f"batched GraNd supports zero padding only (module {path} has "
                f"padding_mode={mod.padding_mode!r}); use the grand_vmap score "
                "method")
        return {"kind": "conv", "path": path,
                "kernel_size": tuple(mod.kernel_size),
                "strides": tuple(mod.stride),
                "padding": _canon_padding(mod.padding),
                "use_bias": mod.bias is not None}
    if isinstance(mod, nn.Linear):
        return {"kind": "dense", "path": path, "use_bias": mod.bias is not None}
    if mod.training or mod.running_mean is None:
        raise ValueError(
            f"batched GraNd requires eval-mode BatchNorm with running statistics "
            f"(module {path} is in training mode or tracks none); use the "
            "grand_vmap score method")
    return {"kind": "bn", "path": path, "epsilon": float(mod.eps),
            "use_scale": mod.weight is not None, "use_bias": mod.bias is not None,
            "mean": mod.running_mean, "var": mod.running_var}


def _sq(x: torch.Tensor, dim) -> torch.Tensor:
    x = x.to(_F32)
    return (x * x).sum(dim=dim)


def _matrix_grad_norm_sq(p: torch.Tensor, go: torch.Tensor) -> torch.Tensor:
    """[B] ⟵ ‖P_iᵀ G_i‖²_F for P [B, S, F], G [B, S, K] in fp32: the Gram
    form where S² dominates F·K, else the direct contraction."""
    s, f, k = p.shape[1], p.shape[-1], go.shape[-1]
    p, go = p.to(_F32), go.to(_F32)
    if s * (f + k) < f * k:
        pp = torch.bmm(p, p.transpose(1, 2))
        gg = torch.bmm(go, go.transpose(1, 2))
        return (pp * gg).sum(dim=(1, 2))
    m = torch.bmm(p.transpose(1, 2), go)
    return (m * m).sum(dim=(1, 2))


def _explicit_padding(padding, x_shape, g_shape, rec: dict):
    """Resolve ``"same"``/``"valid"`` to explicit pairs with XLA's SAME
    arithmetic (NHWC shapes)."""
    if not isinstance(padding, str):
        return padding
    if padding == "valid":
        return ((0, 0), (0, 0))
    out = []
    for d in (1, 2):
        total = max((g_shape[d] - 1) * rec["strides"][d - 1]
                    + rec["kernel_size"][d - 1] - x_shape[d], 0)
        out.append((total // 2, total - total // 2))
    return tuple(out)


def _conv_sfk(rec: dict, x_shape, g_shape) -> tuple[int, int, int]:
    """(S output positions, F patch width, K output channels) of a conv."""
    kh, kw = rec["kernel_size"]
    return g_shape[1] * g_shape[2], kh * kw * x_shape[-1], g_shape[-1]


def _direct_form_ok(s: int, f: int, k: int) -> bool:
    """The direct form is eligible while its FLOPs stay within the ratio of
    the Gram form's."""
    return f * k <= _DIRECT_OVER_GRAM_MAX_RATIO * s * (f + k)


def conv_route(rec: dict, x_shape, g_shape, padding) -> str:
    """The kernel route of one conv layer, in the JAX package's decision order
    with Hopper's own gates: ``"catdot"`` (cat-dot kernel, with USE_CATDOT),
    ``"v2"`` (direct kernel, cotangent tile resident), ``"gram"`` (Gram
    kernel), ``"v1"`` (direct kernel, streaming, any stride) or ``"plain"``
    (im2col and ``torch.bmm``, as JAX leaves such layers to XLA)."""
    s, f, k = _conv_sfk(rec, x_shape, g_shape)
    gram = s * (f + k) < f * k
    direct_ok = _direct_form_ok(s, f, k)
    ks, st = rec["kernel_size"], rec["strides"]
    if STEM_XLA and f < _STEM_PATCH_MIN:
        return "plain"
    if (USE_CATDOT and direct_ok and tuple(st) == (1, 1) and s >= 256
            and kernels.conv_grad_norm_catdot_eligible(x_shape, g_shape, ks, st,
                                                       padding)
            and kernels.conv_grad_norm_direct_fits(x_shape, g_shape, ks, st)):
        return "catdot"
    if direct_ok and kernels.conv_grad_norm_v2_eligible(
            x_shape, g_shape, ks, st, padding):
        return "v2"
    if gram and kernels.conv_grad_norm_gram_eligible(x_shape, g_shape, ks, st,
                                                     padding):
        return "gram"
    if not gram and kernels.conv_grad_norm_direct_fits(x_shape, g_shape, ks, st):
        return "v1"
    return "plain"


def _conv_contrib(rec: dict, x: torch.Tensor, g: torch.Tensor, use_kernels: bool,
                  route_log: list | None) -> torch.Tensor:
    """[B] ‖per-example conv weight gradient‖²_F (+ bias) from NHWC x and g."""
    pad = _explicit_padding(rec["padding"], x.shape, g.shape, rec)
    ks, st = rec["kernel_size"], rec["strides"]
    route = conv_route(rec, x.shape, g.shape, pad) if use_kernels else "plain"
    if route_log is not None:
        route_log.append((rec["path"], route))
    if route == "v2":
        return kernels.conv_grad_norm_sq_v2(x, g, ks, pad, use_bias=rec["use_bias"])
    if route == "gram":
        return kernels.conv_grad_norm_sq_gram(x, g, ks, pad,
                                              use_bias=rec["use_bias"])
    if route == "catdot":
        contrib = kernels.conv_grad_norm_sq_catdot(x, g, ks, pad)
    elif route == "v1":
        contrib = kernels.conv_grad_norm_sq(x, g, ks, st, pad)
    else:
        b, ho, wo, k = g.shape
        patches = kernels.patches(x, ks, st, pad, (ho, wo))
        contrib = _matrix_grad_norm_sq(patches, g.reshape(b, ho * wo, k))
    if rec["use_bias"]:   # JAX's _conv_bias_term; the plain versions share it
        contrib = contrib + kernels.conv_bias_term(g)
    return contrib


def _dense_contrib(rec: dict, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    if x.dim() == 2:
        # ∂W = x gᵀ ⇒ ‖∂W‖² = ‖x‖²‖g‖².
        contrib = _sq(x, 1) * _sq(g, 1)
    else:
        # Applied per position: the weight is shared across positions.
        b = x.shape[0]
        contrib = _matrix_grad_norm_sq(x.reshape(b, -1, x.shape[-1]),
                                       g.reshape(b, -1, g.shape[-1]))
    if rec["use_bias"]:
        gb = g.to(_F32).reshape(g.shape[0], -1, g.shape[-1]).sum(dim=1)
        contrib = contrib + _sq(gb, -1)
    return contrib


def _bn_stats(rec: dict) -> tuple[torch.Tensor, torch.Tensor]:
    return (rec["mean"].to(_F32),
            torch.rsqrt(rec["var"].to(_F32) + rec["epsilon"]))


def _bn_contrib(rec: dict, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Eval-mode BatchNorm grad-norm² from two channel reductions:
    Σ_s g·x̂ = rsqrt(σ²+ε)·(Σ_s g·x − μ·Σ_s g), on NCHW x and g."""
    mean, rstd = _bn_stats(rec)
    axes = tuple(range(2, x.dim()))
    gf = g.to(_F32)
    gx = (gf * x.to(_F32)).sum(dim=axes)
    gs = gf.sum(dim=axes)
    contrib = torch.zeros(x.shape[0], dtype=_F32, device=x.device)
    if rec["use_scale"]:
        contrib = contrib + (((gx - mean * gs) * rstd) ** 2).sum(dim=-1)
    if rec["use_bias"]:
        contrib = contrib + (gs * gs).sum(dim=-1)
    return contrib


def _bn_group_contrib(items: list, use_kernels: bool,
                      route_log: list | None) -> torch.Tensor:
    """Σ over same-shape BatchNorm layers ``items`` [(rec, x, g)] (NCHW) of
    the per-example grad-norm²: with the kernels and USE_BN_KERNEL one
    stacked-BN launch (per-layer (μ, rstd) rows; the layers' NHWC memory is
    passed by pointer, not concatenated), else one plain reduction per layer."""
    rec0, x0, _ = items[0]
    b = x0.shape[0]
    if use_kernels and USE_BN_KERNEL and kernels.bn_grad_norm_eligible(x0.shape):
        if route_log is not None:
            route_log.append(("+".join(rec["path"] for rec, _, _ in items), "bn"))
        stats = torch.stack([torch.stack(_bn_stats(rec)) for rec, _, _ in items])
        out = kernels.bn_grad_norm_sq(
            [x.permute(0, 2, 3, 1).contiguous() for _, x, _ in items],
            [g.permute(0, 2, 3, 1).contiguous() for _, _, g in items], stats,
            use_scale=rec0["use_scale"], use_bias=rec0["use_bias"])
        return out.reshape(len(items), b).sum(dim=0)
    total = torch.zeros(b, dtype=_F32, device=x0.device)
    for rec, x, g in items:
        total = total + _bn_contrib(rec, x, g)
    return total


def _check_covered(model: nn.Module, records: list[dict]) -> None:
    """Every parameter must belong to a hooked layer that ran, or its gradient
    would be silently missing from the norm."""
    covered = {rec["path"] for rec in records}
    for path, mod in model.named_modules():
        if path not in covered and any(True for _ in mod.parameters(recurse=False)):
            raise NotImplementedError(
                f"batched GraNd: parameters at {path or '<root>'} belong to a "
                "module the hooks do not cover (only Conv2d/Linear/BatchNorm, "
                "each run once); use the grand_vmap score method")


def _refuse_shared_modules(records: list[dict]) -> None:
    counts = Counter(rec["path"] for rec in records)
    dupes = sorted(p for p, c in counts.items() if c > 1)
    if dupes:
        raise NotImplementedError(
            f"batched GraNd: module(s) applied more than once per forward "
            f"({dupes}): weight sharing needs the gradient summed across calls "
            "before the norm; use the grand_vmap score method")


def batched_grand_scores(model: nn.Module, variables: dict, image: torch.Tensor,
                         label: torch.Tensor, mask: torch.Tensor,
                         use_kernels: bool = False,
                         route_log: list | None = None) -> torch.Tensor:
    """Exact per-example GraNd over all parameters, fully batched: [B] float32.

    ``image`` is NHWC on the variables' device. ``use_kernels`` routes conv
    layers through the hand-written kernels (``conv_route``; on CPU tensors
    the kernels' plain versions run); False sends every conv down the plain
    im2col route. ``route_log`` (a list) receives ``(layer path, route)`` per
    conv layer or group and ``(paths, "bn")`` per stacked-BN launch."""
    from .scores import cross_entropy   # scores.py imports this module

    names = {mod: path for path, mod in model.named_modules()}
    records: list[dict] = []
    xs: list[torch.Tensor] = []
    ys: list[torch.Tensor] = []

    def hook(mod, args, out):
        records.append(_record_for(names[mod], mod))
        xs.append(args[0])
        ys.append(out)

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, _HOOKED)]
    try:
        with torch.enable_grad():
            img = image.detach().requires_grad_(True)
            logits = functional_call(model, variables, (img,))
            _check_covered(model, records)
            _refuse_shared_modules(records)
            loss = (cross_entropy(logits, label) * mask).sum()
            cotangents = torch.autograd.grad(loss, ys, allow_unused=True)
    finally:
        for h in handles:
            h.remove()

    batch = image.shape[0]
    norm_sq = torch.zeros(batch, dtype=_F32, device=image.device)
    # Same-geometry layers form one group (GROUP_CONV / GROUP_BN), scored by
    # one launch over the batch-concatenated layers, as in the JAX package;
    # without the toggles every layer is its own group.
    conv_groups: dict[tuple, list] = {}
    bn_groups: dict[tuple, list] = {}
    for rec, x, y, g in zip(records, xs, ys, cotangents):
        x = x.detach()
        g = torch.zeros_like(y) if g is None else g
        if rec["kind"] == "conv":
            key = (tuple(x.shape), tuple(g.shape), rec["kernel_size"], rec["strides"],
                   rec["padding"], rec["use_bias"],
                   None if GROUP_CONV else rec["path"])
            # NCHW views of channels_last memory -> contiguous NHWC (no copy).
            conv_groups.setdefault(key, []).append(
                (rec, x.permute(0, 2, 3, 1).contiguous(),
                 g.permute(0, 2, 3, 1).contiguous()))
        elif rec["kind"] == "dense":
            norm_sq = norm_sq + _dense_contrib(rec, x, g)
        else:
            key = (tuple(x.shape), rec["epsilon"], rec["use_scale"], rec["use_bias"],
                   None if GROUP_BN else rec["path"])
            bn_groups.setdefault(key, []).append((rec, x, g))
    for items in conv_groups.values():
        if len(items) == 1:
            rec, x, g = items[0]
            norm_sq = norm_sq + _conv_contrib(rec, x, g, use_kernels, route_log)
            continue
        rec = dict(items[0][0], path="+".join(r["path"] for r, _, _ in items))
        contrib = _conv_contrib(rec, torch.cat([x for _, x, _ in items]),
                                torch.cat([g for _, _, g in items]), use_kernels,
                                route_log)
        norm_sq = norm_sq + contrib.reshape(len(items), batch).sum(dim=0)
    for items in bn_groups.values():
        norm_sq = norm_sq + _bn_group_contrib(items, use_kernels, route_log)
    return torch.sqrt(norm_sq) * mask


def _mega_conv_route(rec: dict, x_shape, g_shape) -> bool:
    """Whether a conv takes the megakernel in the fused backward: a patch
    width of at least ``_STEM_PATCH_MIN`` (unconditionally, unlike STEM_XLA),
    the direct-form predicate shared with the two-phase route, and the
    kernel's own gate."""
    s, f, k = _conv_sfk(rec, x_shape, g_shape)
    if f < _STEM_PATCH_MIN or not _direct_form_ok(s, f, k):
        return False
    return kernels.conv_bwd_grad_norm_eligible(x_shape, g_shape, rec["kernel_size"],
                                               rec["strides"])


class _Tap(torch.autograd.Function):
    """Identity on a layer output ``y``. Its backward runs ``layer(x, g)`` on
    the layer input and the output cotangent and returns what that gives:
    the cotangent passed on to ``y`` (``None`` on the megakernel route, so the
    conv's own backward receives nothing and computes nothing), the cotangent
    of ``x`` (the megakernel's ``dx``, else ``None``) and the layer's [B]
    grad-norm² contribution as the gradient of its accumulator ``acc``."""

    @staticmethod
    def forward(ctx, y, x, acc, layer):
        ctx.layer = layer
        ctx.save_for_backward(x)
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        g_y, g_x, contrib = ctx.layer(x.detach(), g)
        return g_y, g_x, contrib, None


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1).contiguous()


def _fused_layer(rec: dict, use_kernels: bool, weight: torch.Tensor | None,
                 route_log: list | None):
    """The backward of one layer's tap (see ``_Tap``); ``weight`` (a conv's,
    on the megakernel route) selects the megakernel where the layer is
    eligible."""
    def layer(x, g):
        if rec["kind"] == "dense":
            return g, None, _dense_contrib(rec, x, g)
        if rec["kind"] == "bn":
            return g, None, _bn_contrib(rec, x, g)
        xn, gn = _nhwc(x), _nhwc(g)
        if weight is not None and _mega_conv_route(rec, xn.shape, gn.shape):
            if route_log is not None:
                route_log.append((rec["path"], "mega"))
            pad = _explicit_padding(rec["padding"], xn.shape, gn.shape, rec)
            dx, contrib = kernels.conv_bwd_grad_norm_sq(
                xn, gn, weight, rec["kernel_size"], pad, use_bias=rec["use_bias"])
            return None, dx.permute(0, 3, 1, 2), contrib
        return g, None, _conv_contrib(rec, xn, gn, use_kernels, route_log)
    return layer


def batched_grand_scores_fused(model: nn.Module, variables: dict, image: torch.Tensor,
                               label: torch.Tensor, mask: torch.Tensor,
                               use_kernels: bool = False, megakernel: bool = False,
                               route_log: list | None = None) -> torch.Tensor:
    """Exact per-example GraNd with each layer's contraction inside the
    backward pass: the same quantity as ``batched_grand_scores``.

    A forward hook wraps every Conv/Linear/BatchNorm output in a ``_Tap``
    with its own [B] accumulator; one ``torch.autograd.grad`` of Σ CE·mask
    with respect to the accumulators runs one backward in which each layer's
    contraction follows the op that produced its cotangent, and yields every
    layer's contribution. ``megakernel`` (needs ``use_kernels``): eligible
    unit-stride convs (``_mega_conv_route``) get their input cotangent and
    contraction from one ``conv_bwd_grad_norm`` launch and their own backward
    gets no output cotangent; the other layers keep the plain taps.
    ``route_log`` as in ``batched_grand_scores``, plus ``(path, "mega")``."""
    from .scores import cross_entropy   # scores.py imports this module

    # The fused backward contracts strictly per layer: grouping and the
    # stacked-BN kernel exist only in the two-phase route. Refuse rather than
    # run a program other than the one the toggles name.
    if GROUP_CONV or GROUP_BN or USE_BN_KERNEL:
        raise ValueError(
            "DDT_GRAND_FUSED=1/DDT_GRAND_MEGAKERNEL=1 is incompatible with "
            "DDT_GRAND_GROUP_CONV/GROUP_BN/BN_KERNEL (the fused backward "
            "contracts per layer; grouping exists only in the two-phase path)")
    if megakernel and not use_kernels:
        raise ValueError(
            "DDT_GRAND_MEGAKERNEL=1 requires the kernel route "
            "(score.use_pallas must not be disabled)")

    names = {mod: path for path, mod in model.named_modules()}
    batch = image.shape[0]
    records: list[dict] = []
    accs: list[torch.Tensor] = []

    def hook(mod, args, out):
        rec = _record_for(names[mod], mod)
        records.append(rec)
        acc = torch.zeros(batch, dtype=_F32, device=image.device, requires_grad=True)
        accs.append(acc)
        weight = mod.weight if megakernel and rec["kind"] == "conv" else None
        return _Tap.apply(out, args[0], acc,
                          _fused_layer(rec, use_kernels, weight, route_log))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, _HOOKED)]
    try:
        with torch.enable_grad():
            logits = functional_call(model, variables, (image.detach(),))
            _check_covered(model, records)
            _refuse_shared_modules(records)
            loss = (cross_entropy(logits, label) * mask).sum()
            contribs = torch.autograd.grad(loss, accs, allow_unused=True)
    finally:
        for h in handles:
            h.remove()
    norm_sq = torch.zeros(batch, dtype=_F32, device=image.device)
    for c in contribs:
        if c is not None:
            norm_sq = norm_sq + c
    return torch.sqrt(norm_sq) * mask
