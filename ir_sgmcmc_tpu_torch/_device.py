"""The device of state that an entry point creates without an input tensor."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card.

    The port runs on the card unless the caller asks for the CPU: with no
    device given and no CUDA available this raises, and there is no CPU
    fallback."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is available; pass device="cpu" to '
                           "run the port on the CPU")
    return torch.device("cuda")
