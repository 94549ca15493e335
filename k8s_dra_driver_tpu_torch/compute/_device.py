"""The port's device convention: the card unless the caller asks for the CPU.

Shared by the serving engine, the burn-in workloads and ``entry()``.
"""

from __future__ import annotations

from typing import Union

import torch


def _resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """``None`` is the current CUDA device. A CUDA device without CUDA
    raises: nothing falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
