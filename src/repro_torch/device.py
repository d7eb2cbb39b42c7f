"""Where the port's entry points run."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card: entry points run on ``cuda`` unless the
    caller asks for the CPU.  A CUDA device on a machine without CUDA
    raises rather than quietly running the plain CPU path."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' "
            "to run the plain PyTorch path")
    return dev
