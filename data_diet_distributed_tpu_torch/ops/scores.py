"""Per-example importance scores (counterpart of ``data_diet_distributed_tpu/ops/scores.py``).

EL2N ``‖softmax(f(x)) − onehot(y)‖₂``, margin, correctness, closed-form
last-layer GraNd, full-parameter GraNd through the batched exact algorithm
(``grand_batched.py``; two-phase, fused or megakernel route by its toggles)
and per-example ``vmap(grad)`` GraNd (``grand_vmap``). Scoring runs in eval
mode by default; ``eval_mode=False`` normalizes BatchNorm by the scoring
batch's own statistics (padded rows included) and throws the statistics
away, as the JAX package does (``scores.py:84-95``): the scored variables are
never written.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F
from torch.func import functional_call

from ..graphs import ChunkProgram
from ..models.resnet import no_remat
from . import grand_batched, kernels


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example CE loss, [B] <- logits [B, C], labels [B]."""
    return F.cross_entropy(logits.float(), labels.long(), reduction="none")


def el2n_from_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """L2 error of the softmax vector against the one-hot target."""
    probs = torch.softmax(logits.float(), dim=-1)
    err = probs - F.one_hot(labels.long(), logits.shape[-1]).float()
    return torch.sqrt((err * err).sum(dim=-1))


def margin_from_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``max_{k≠y} p_k − p_y`` ∈ [−1, 1]; higher = harder."""
    probs = torch.softmax(logits.float(), dim=-1)
    onehot = F.one_hot(labels.long(), logits.shape[-1]).float()
    p_true = (probs * onehot).sum(dim=-1)
    p_other = (probs - onehot).max(dim=-1).values
    return p_other - p_true


def grand_last_layer_from_logits(logits: torch.Tensor, features: torch.Tensor,
                                 labels: torch.Tensor) -> torch.Tensor:
    """Exact GraNd of the classifier layer alone: ‖p − y‖·sqrt(‖h‖² + 1)."""
    probs = torch.softmax(logits.float(), dim=-1)
    err = probs - F.one_hot(labels.long(), logits.shape[-1]).float()
    err_sq = (err * err).sum(dim=-1)
    feat_sq = (features.float() ** 2).sum(dim=-1)
    return torch.sqrt(err_sq * (feat_sq + 1.0))


def _forward(model, variables, images, capture_features: bool = False,
             eval_mode: bool = True):
    """Forward of ``model`` on ``variables`` with no autograd graph, BatchNorm
    on running statistics (``eval_mode``) or on the batch's own."""
    model.train(not eval_mode)
    with torch.no_grad():
        return functional_call(model, variables, (images,),
                               {"capture_features": capture_features})


def resolve_use_kernels(use_pallas: bool | None) -> bool:
    """``score.use_pallas``: None (auto) and True take the kernels on CUDA
    tensors; False takes the plain route everywhere. CPU tensors always run
    the kernels' plain versions."""
    return True if use_pallas is None else bool(use_pallas)


def make_local_scores(model, method: str, *, chunk: int = 32, eval_mode: bool = True,
                      use_kernels: bool = False):
    """``(variables, image, label, mask) -> scores [B]`` float32 for ``method``
    — the one definition shared by ``score_dataset`` and the serving engine.
    ``chunk`` is ``grand_vmap``'s examples per ``vmap``; the GraNd route
    toggles of ``grand_batched`` are read when this is called. The batched
    GraNd algorithm always runs BatchNorm in eval mode, as in JAX
    (``resolve_score_method`` sends ``grand`` in train mode to ``grand_vmap``)."""
    forward = partial(_forward, eval_mode=eval_mode)

    if method == "el2n":
        def local_scores(variables, image, label, mask):
            logits = forward(model, variables, image)
            if use_kernels:
                return kernels.el2n(logits, label, mask)
            return el2n_from_logits(logits, label) * mask
        return local_scores

    if method == "margin":
        def local_scores(variables, image, label, mask):
            return margin_from_logits(forward(model, variables, image), label) * mask
        return local_scores

    if method == "correctness":
        def local_scores(variables, image, label, mask):
            logits = forward(model, variables, image)
            return (logits.argmax(dim=-1) == label).float() * mask
        return local_scores

    if method == "grand_last_layer":
        def local_scores(variables, image, label, mask):
            logits, feats = forward(model, variables, image, capture_features=True)
            if use_kernels:
                # The kernel redoes the classifier product in fp32 from the fp32
                # features; the model's own logits (bf16 compute under half
                # precision) are not part of this route's result.
                return kernels.grand_last_layer(feats, variables["classifier.weight"],
                                                variables["classifier.bias"], label,
                                                mask)
            return grand_last_layer_from_logits(logits, feats, label) * mask
        return local_scores

    if method == "grand_batched":
        # Module attributes, read now: the toggles pick the route per factory call.
        if grand_batched.MEGAKERNEL:
            score_fn = partial(grand_batched.batched_grand_scores_fused, megakernel=True)
        elif grand_batched.FUSED_BWD:
            score_fn = grand_batched.batched_grand_scores_fused
        else:
            score_fn = grand_batched.batched_grand_scores

        def local_scores(variables, image, label, mask):
            model.eval()
            return score_fn(model, variables, image, label, mask,
                            use_kernels=use_kernels)
        return local_scores

    if method == "grand_vmap":
        return _make_grand_vmap(model, chunk, eval_mode)
    raise ValueError(f"unknown score method {method!r}")


def _make_grand_vmap(model, chunk: int, eval_mode: bool = True):
    """Per-example GraNd the naive way: ``vmap(grad)`` of each example's loss
    over every parameter, ``chunk`` examples per ``vmap``; the norm is taken
    in fp32 over all parameter gradients (``optax.global_norm`` in JAX). In
    train mode each example's ``image[None]`` forward normalizes BatchNorm
    over that one example's positions, as JAX's does (``scores.py:206-211``)."""
    param_names = frozenset(name for name, _ in model.named_parameters())

    def loss(params, buffers, image, label):
        logits = functional_call(model, {**params, **buffers}, (image[None],))
        return cross_entropy(logits, label[None])[0]

    per_example_grads = torch.func.vmap(torch.func.grad(loss), in_dims=(None, None, 0, 0))

    def local_scores(variables, image, label, mask):
        model.train(not eval_mode)
        params = {k: v for k, v in variables.items() if k in param_names}
        buffers = {k: v for k, v in variables.items() if k not in param_names}
        norms = []
        for i in range(0, image.shape[0], chunk):
            with no_remat():   # torch.func refuses checkpoint's saved-tensor hooks
                grads = per_example_grads(params, buffers, image[i:i + chunk],
                                          label[i:i + chunk])
            sq = sum(gr.float().reshape(gr.shape[0], -1).pow(2).sum(dim=1)
                     for gr in grads.values())
            norms.append(torch.sqrt(sq))
        return torch.cat(norms) * mask
    return local_scores


def resolve_score_method(method: str, eval_mode: bool) -> str:
    """``grand`` is the batched exact algorithm in eval mode, ``vmap(grad)``
    otherwise."""
    if method == "grand":
        return "grand_batched" if eval_mode else "grand_vmap"
    return method


def make_warmup_scores(model, method: str, *, chunk: int = 32, eval_mode: bool = True):
    """``method``'s plain route, which launches no hand-written kernel: a
    score chunk's warm-up before its capture. The batched GraNd algorithm
    warms on its two-phase plain route whatever the route toggles (the
    megakernel route refuses to run without the kernels): the same model's
    forward and backward at the same geometry."""
    if method == "grand_batched":
        def local_scores(variables, image, label, mask):
            model.eval()
            return grand_batched.batched_grand_scores(model, variables, image, label, mask,
                                                      use_kernels=False)
        return local_scores
    return make_local_scores(model, method, chunk=chunk, eval_mode=eval_mode,
                             use_kernels=False)


def make_score_chunk(local_scores, variables: dict, k: int, batch: int,
                     image_shape: tuple, device, warm_scores=None, harvest: bool = True):
    """K score batches as ONE dispatch (the JAX package's ``make_score_chunk``,
    ``ops/scores.py:343-400``): a ``graphs.ChunkProgram`` whose static
    buffers take a seed's ``variables`` and a ``[K, B, ...]`` block of the
    pre-batched dataset (``ops/scoring.py::ScoreResident.blocks``) before each
    dispatch, so one capture serves every block and every seed; K calls of
    ``local_scores`` (the per-batch function, unchanged) write the ``[K, B]``
    score block. On the card the replay launches what the per-batch calls
    launch: on the default GraNd route the direct and Gram kernels, for EL2N
    ``el2n.cu``. The warm-up before the capture is one batch of
    ``warm_scores``, the method's plain route (``make_warmup_scores``: the same
    PyTorch operations around the kernels, and no hand-written kernel, whose
    launches then count only where the card runs them), after every kernel's
    library is built and loaded (``kernels.load_all``); without
    ``warm_scores`` the warm-up is a batch of ``local_scores``."""
    copied = {f"var:{n}": t for n, t in variables.items()}
    copied.update(images=((k, batch, *image_shape), torch.float32),
                  labels=((k, batch), torch.int32), mask=((k, batch), torch.float32))

    def body(fn, inputs: dict, j: int) -> torch.Tensor:
        v = {n: inputs[f"var:{n}"] for n in variables}
        return fn(v, inputs["images"][j], inputs["labels"][j], inputs["mask"][j])

    def run(inputs: dict) -> dict:
        return {"scores": torch.stack([body(local_scores, inputs, j) for j in range(k)])}

    def warmup(inputs: dict) -> torch.Tensor:
        kernels.load_all()
        return body(warm_scores or local_scores, inputs, 0)

    return ChunkProgram("score_chunk", run, device, k=k, copied=copied,
                        warmup=warmup, examples=batch, harvest=harvest,
                        key=("score_chunk", k, (batch, *image_shape), "float32"))
