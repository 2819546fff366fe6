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


def resolve_devices(devices=None) -> list:
    """``devices`` as a list of ``torch.device``\\ s; ``None`` means every
    visible CUDA card, and raises without one (no CPU fallback).  A device
    may appear more than once (virtual shards of one card or of the CPU)."""
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        if not devices:
            raise ValueError("an empty device list")
        return devices
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is available; pass device="cpu" (or devices='
                           '["cpu", ...]) to run the port on the CPU')
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
