"""The port's device rule: entry points run on the GPU unless told otherwise."""
from __future__ import annotations

import torch

__all__ = ["pin_fp32", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device; ``"cpu"`` -> the plain versions.

    Raises when the GPU is asked for and there is none: a missing card is
    never silently replaced by the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run the plain versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def pin_fp32() -> None:
    """Keep float32 matmuls and convolutions in full float32 (no TF32).

    The port's f32 paths (the model's projections, attention, the plain
    versions' chunk products) are held against the reference at float32
    tolerances; TF32 keeps about three decimal digits.  The entry points
    of those paths call this, so a caller that turned TF32 on does not
    change their answers.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
