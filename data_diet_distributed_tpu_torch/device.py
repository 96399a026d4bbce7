"""Device resolution and the numeric switches of the scoring path.

Entry points default to ``device="cuda"`` and raise when CUDA is missing,
unless the caller passed ``device="cpu"`` (as the CPU tests do). Nothing picks
the CPU on its own.
"""

from __future__ import annotations

import torch

from .parallel.mesh import world_size


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. Raises when a CUDA device is asked for (or implied)
    and none is available. In a process group of several ranks, CUDA without
    an index is the rank's own card (``cuda:{current device}``, which
    ``parallel.mesh.initialize_multihost`` set)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (cuda | cpu)")
    if dev.type == "cuda" and dev.index is None and world_size() > 1:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def set_parity_mode(enabled: bool = True) -> None:
    """Full-fp32 matmuls and convolutions on the card: TF32 off for cuBLAS and
    cuDNN (cuDNN convolutions default to TF32, which keeps ~3 decimal digits).
    For comparisons against an fp32 reference; process-wide. ``False``
    restores PyTorch's defaults (matmul TF32 off, cuDNN TF32 on)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = not enabled


def set_scoring_determinism() -> None:
    """Deterministic cuDNN algorithms picked by heuristics, not by timing
    (``benchmark=False``): the same batch geometry then runs the same
    algorithms in every call, which the serving engine's guarantee (a padded
    request scores bit-identical to the resident pass) and a reproducible
    ``fit`` (bitwise from run to run and across a resume) rest on.
    Process-wide; training sets it too, so it never turns it off."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
