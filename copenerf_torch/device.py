"""Device resolution for the port's entry points.

Entry points default to ``device="cuda"``; they run on the CPU only when the
caller asks for it. Asking for CUDA where there is none raises instead of
silently falling back. A bare ``"cuda"`` is this process's card: torchrun's
``LOCAL_RANK`` (0 in a single process).
"""

from __future__ import annotations

import torch

from .parallel.distributed import local_rank


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank())
    return dev
