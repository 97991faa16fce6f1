"""Device selection shared by the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]]
                   ) -> torch.device:
    """``None`` means the CUDA device; raise when there is none.

    Entry points never drop to the CPU on their own: a caller that wants
    the CPU (the tests) asks for ``"cpu"`` explicitly.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' explicitly to run the "
                "plain PyTorch path on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        # the concrete device, so it compares equal to a tensor's .device
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
