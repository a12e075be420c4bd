"""The torch device of the on-device engines."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``device`` when one is given; otherwise the current CUDA device,
    as the reference engines run on the default accelerator.  Raises
    when none is given and no CUDA device is present, so a device engine
    never runs on the host unasked (pass ``device="cpu"`` for that)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device= to run this "
                           "engine on another torch device")
    return torch.device("cuda", torch.cuda.current_device())
