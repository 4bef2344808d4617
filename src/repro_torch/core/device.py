"""Where the port's entry points run.

Entry points run on the card unless the caller asks for the CPU: with no
``device`` they take ``cuda`` and raise when there is none, so a run
that was meant for the GPU never carries on quietly on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the current CUDA card; anything else is taken as
    given (``"cpu"`` is how tests and CPU runs ask for the CPU).  A CUDA
    device always comes back with its index, so devices compare equal
    to a tensor's ``.device``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(--device cpu) to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (a no-op on the CPU), so a host
    clock read after it times the work and not its enqueueing."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
