"""Model variables: the Flax weight port and seeded initialization.

Variables are a ``state_dict``-shaped mapping of tensors (parameters and
BatchNorm statistics); the scoring path runs a model on them with
``torch.func.functional_call``, the counterpart of Flax's ``apply(variables)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from .device import resolve_device
from .models import create_model

# Flax's truncated-normal variance scaling divides the std by this (the std of a
# unit normal truncated to [-2, 2]).
_TRUNC_STD = 0.87962566103423978


def _flatten(tree: dict, prefix: tuple = ()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def params_from_flax(tree: dict, model: nn.Module | None = None) -> dict:
    """Flax variables (``{"params": ..., "batch_stats": ...}`` as nested dicts
    of numpy arrays) -> a ``state_dict``: conv kernels ``[kh, kw, C, K]`` ->
    ``[K, C, kh, kw]``, dense kernels ``[F, C]`` -> ``[C, F]``, BatchNorm
    ``scale/bias/mean/var`` -> ``weight/bias/running_mean/running_var``. With
    ``model`` the result is loaded into it with ``strict=True``, which proves
    every parameter of the model was ported and nothing else."""
    sd = {}
    for path, value in _flatten(tree.get("params", {})):
        key, leaf = ".".join(path[:-1]), path[-1]
        value = np.asarray(value, np.float32)
        if leaf == "kernel" and value.ndim == 4:
            sd[f"{key}.weight"] = torch.from_numpy(value.transpose(3, 2, 0, 1).copy())
        elif leaf == "kernel" and value.ndim == 2:
            sd[f"{key}.weight"] = torch.from_numpy(value.T.copy())
        elif leaf == "scale":
            sd[f"{key}.weight"] = torch.from_numpy(value.copy())
        elif leaf == "bias":
            sd[f"{key}.bias"] = torch.from_numpy(value.copy())
        else:
            raise KeyError(f"unmapped Flax parameter {'/'.join(path)}")
    for path, value in _flatten(tree.get("batch_stats", {})):
        key, leaf = ".".join(path[:-1]), path[-1]
        name = {"mean": "running_mean", "var": "running_var"}.get(leaf)
        if name is None:
            raise KeyError(f"unmapped Flax batch statistic {'/'.join(path)}")
        sd[f"{key}.{name}"] = torch.from_numpy(np.asarray(value, np.float32).copy())
    if model is not None:
        model.load_state_dict(sd, strict=True)
    return sd


def variables_to(variables: dict, device) -> dict:
    """Variables on ``device``, 4-D conv weights in channels_last like the
    activations they meet."""
    out = {}
    for k, v in variables.items():
        v = v.to(device)
        if v.dim() == 4:
            v = v.contiguous(memory_format=torch.channels_last)
        out[k] = v
    return out


def _trunc_normal(t: torch.Tensor, fan_in: int, scale: float,
                  gen: torch.Generator) -> None:
    std = math.sqrt(scale / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)


def init_variables(arch: str, seed: int, device=None, *, num_classes: int = 10,
                   stem: str = "cifar") -> dict:
    """Freshly initialized variables for ``arch``, as the Flax models
    initialize (``resnet.py:29-32,57``): He-normal (truncated) convs,
    LeCun-normal classifier with zero bias, BatchNorm scale 1 / bias 0 /
    mean 0 / var 1, and the BatchNorm closing each residual branch with scale
    0. Drawn from a ``torch.Generator`` seeded with ``seed`` on the CPU, so
    the numbers are the same on every device (and differ from
    ``jax.random``'s)."""
    device = resolve_device(device)
    model = create_model(arch, num_classes, stem=stem)
    gen = torch.Generator().manual_seed(int(seed))
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            _trunc_normal(mod.weight, mod.weight[0].numel(), 2.0, gen)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.Linear):
            _trunc_normal(mod.weight, mod.in_features, 1.0, gen)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.BatchNorm2d):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
            mod.reset_running_stats()
    for mod in model.modules():   # after the pass above, which sets scales to 1
        closing = getattr(mod, "closing_norm", None)
        if closing is not None:
            nn.init.zeros_(getattr(mod, closing).weight)
    sd = {k: v for k, v in model.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    return variables_to(sd, device)
