"""Device selection and weight conversion."""

from __future__ import annotations

import torch


def select_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raise if it names a card that is absent.

    The entry points run on the card unless the caller asks for the CPU: there
    is no silent fall-back.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} was asked for but no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    return dev
