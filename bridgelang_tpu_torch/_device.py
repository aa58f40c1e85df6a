"""Device resolution for the port's entry points.

The port serves on the GPU. An entry point given no device asks for CUDA and
raises when there is none: it never falls back to the CPU on its own. The CPU
runs only when a caller asks for it, as the tests do.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` -> `cuda`. A CUDA device without a usable card raises
    `RuntimeError`; `"cpu"` is returned as asked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain-torch path explicitly"
        )
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {str(dev)!r}: the port runs on 'cuda' or 'cpu'")
    return dev

