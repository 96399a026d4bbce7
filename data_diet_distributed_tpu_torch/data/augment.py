"""Training augmentation on the device: horizontal flip and zero-pad random crop
(counterpart of ``data_diet_distributed_tpu/data/augment.py``).

Split in two: ``draw_augment`` draws the flip mask and the crop offsets from
a ``torch.Generator`` seeded from ``(seed, step)`` (on the CPU, so every
device gets the same draws, and a resumed run the same ones), and
``apply_augment`` moves the pixels. The draws differ from the JAX package's
``jax.random`` draws by design, as ``weights.init_variables`` differs from
Flax's init; given the same draws, ``apply_augment`` equals JAX's
``augment_images`` bit for bit. The crop pads the normalized images with
zeros, as the JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def draw_augment(seed: int, step: int, batch: int, crop_pad: int = 4,
                 flip: bool = True) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """``(flip_mask [B] bool or None, offsets [B, 2] int64 or None)`` for
    training step ``step``: a pure function of ``(seed, step)``. Offsets are
    the crop's top-left corner in the padded image, in ``[0, 2 * crop_pad]``."""
    key = int(np.random.SeedSequence([int(seed), int(step)]).generate_state(
        1, np.uint64)[0])
    gen = torch.Generator().manual_seed(key)
    flips = torch.rand(batch, generator=gen) < 0.5 if flip else None
    offsets = (torch.randint(0, 2 * crop_pad + 1, (batch, 2), generator=gen)
               if crop_pad else None)
    return flips, offsets


def _to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``; to a card through pinned memory, so the copy does
    not wait for the device's queue to drain."""
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def apply_augment(images: torch.Tensor, flips: torch.Tensor | None,
                  offsets: torch.Tensor | None, crop_pad: int = 4) -> torch.Tensor:
    """Flip the rows of ``flips`` left-right, then cut an ``H x W`` window at
    ``offsets`` out of each image zero-padded by ``crop_pad``: NHWC in, NHWC
    out, no arithmetic on the pixels."""
    if flips is not None:
        flips = _to(flips, images.device)
        images = torch.where(flips[:, None, None, None], images.flip(2), images)
    if offsets is not None and crop_pad:
        b, h, w, _ = images.shape
        p = crop_pad
        padded = F.pad(images, (0, 0, p, p, p, p))
        offsets = _to(offsets, images.device)
        rows = offsets[:, 0, None] + torch.arange(h, device=images.device)
        cols = offsets[:, 1, None] + torch.arange(w, device=images.device)
        batch = torch.arange(b, device=images.device)
        images = padded[batch[:, None, None], rows[:, :, None], cols[:, None, :]]
    return images


def augment_batch(images: torch.Tensor, seed: int, step: int, crop_pad: int = 4,
                  flip: bool = True,
                  image_slice: tuple[int, int] | None = None) -> torch.Tensor:
    """Draw for ``(seed, step)`` and apply: the training step's augmentation.
    With ``image_slice=(r, W)`` the images are rank r's rows of a global batch
    of ``W·len(images)``: the draws are the global batch's and the rank
    applies its own rows of them, so W ranks crop as one process does."""
    b = images.shape[0]
    if image_slice is None:
        flips, offsets = draw_augment(seed, step, b, crop_pad, flip)
    else:
        r, w = image_slice
        flips, offsets = draw_augment(seed, step, b * w, crop_pad, flip)
        flips = None if flips is None else flips[r * b:(r + 1) * b]
        offsets = None if offsets is None else offsets[r * b:(r + 1) * b]
    return apply_augment(images, flips, offsets, crop_pad)
