"""The torch device of the on-device engines."""

from __future__ import annotations

import torch


class NoDeviceError(RuntimeError):
    """A device engine was asked to run with no device given and no
    CUDA device present."""


def resolve(device=None) -> torch.device:
    """``device`` when one is given; otherwise the current CUDA device,
    as the reference engines run on the default accelerator.  Raises
    when none is given and no CUDA device is present, so a device engine
    never runs on the host unasked (pass ``device="cpu"`` for that)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise NoDeviceError("no CUDA device: pass device= (the CLI's "
                            "--device) to run this engine on another "
                            "torch device")
    return torch.device("cuda", torch.cuda.current_device())


def cuda_or_none(device=None):
    """The CUDA device a card path takes, or None for the host path:
    ``device`` when it names a CUDA device; with ``device`` None the
    current CUDA device where there is one."""
    if device is None:
        return resolve() if torch.cuda.is_available() else None
    dev = torch.device(device)
    return dev if dev.type == "cuda" else None
