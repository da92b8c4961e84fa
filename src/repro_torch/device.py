"""The port's one device rule: the CUDA card unless the caller asks for
another device.  Without a card and without an explicit device, entry points
raise instead of carrying on quietly on the CPU."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found; pass device='cpu' to run the port's "
            "plain PyTorch path on the CPU")
    return torch.device("cuda")
