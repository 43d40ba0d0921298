"""Device choice for the port's entry points: CUDA unless the caller asks."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the current CUDA device and raises when there is none: the
    port never falls back to the CPU on its own. Tests pass ``device="cpu"``.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
