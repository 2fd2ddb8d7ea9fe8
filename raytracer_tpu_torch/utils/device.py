"""Device resolution: the counterpart of ``raytracer_tpu/utils/platform.py``.

Every entry point of the port defaults to ``"cuda"``. A CUDA request on a
machine without a usable CUDA device raises; nothing falls back to the CPU
silently. The CPU is used only when a caller asks for it by name.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device = DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``; raises if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to render with the plain PyTorch twin"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r} (use 'cuda' or 'cpu')")
    return dev
