"""Small shared utilities for the PyTorch port: the pow2 batch padding
rule of ``repro.core.util`` and the device rule every entry point follows.

``resolve_device`` is the port's one device policy: entry points run on
``cuda`` unless the caller passes ``device="cpu"``, and with no GPU they
raise instead of carrying on on the CPU in silence.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["pow2_at_least", "resolve_device"]


def pow2_at_least(b: int) -> int:
    """Smallest power of two >= ``b`` (and >= 1).

    ``pow2_at_least(0) == 1`` by convention: an empty batch still pads
    to a single lane, so downstream fixed-shape programs never see a
    zero-length axis.
    """
    if b < 0:
        raise ValueError(f"b must be >= 0, got {b}")
    if b <= 1:
        return 1
    return 1 << (int(b) - 1).bit_length()


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``. A CUDA device without a GPU raises with a
    message that names the explicit CPU opt-in."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no GPU is available; "
            "pass device=\"cpu\" to run the plain PyTorch versions on the "
            "CPU")
    return dev
