"""Where the port's entry points put their tensors.

The port runs on the CUDA card unless the caller asks for the CPU: an entry
point given no ``device`` takes the current CUDA device, and raises where
there is none.  There is no fallback to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means the card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA card (torch.cuda.is_available() is False): the port "
                "runs on the card by default; pass device='cpu' to run on "
                "the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device
