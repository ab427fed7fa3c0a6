"""Device selection: the card by default, the CPU only when asked for."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``"cuda"``. A CUDA device without a usable GPU
    raises: nothing drops silently to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "awesome_tpu_torch runs on CUDA by default and no GPU is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev
