"""The device an entry point runs on.

The port is written for one CUDA card: every public entry point takes a
``device`` argument that defaults to ``"cuda"``. Without a card it raises
:class:`DeviceError` rather than fall back to the CPU, so a run that was
meant for the card can never report CPU numbers by accident. Callers that
want the CPU (the parity tests, the card-vs-CPU check) say ``device="cpu"``;
internal helpers take the device of their caller.
"""

from __future__ import annotations

import torch

from vaq_tpu_torch.errors import DeviceError

DEFAULT = "cuda"


def resolve(device: torch.device | str = DEFAULT) -> torch.device:
    """``device`` as a ``torch.device``; raises DeviceError for a CUDA device
    when no card is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is false; pass device='cpu' to run on the CPU")
    return dev
