"""Single-card entry point: counterpart of ``__graft_entry__.py``.

``entry()`` (reference ``:23-36``) returns ``(fn, args)`` for the
flagship compute step, the full-depth octree analysis compacted on the
device: ``fn(codes)`` is ``ops.octree.encode_analysis_packed`` at depth
10 in PARENT context mode, ``args`` 4,096 sorted random Morton codes
from seed 0.  ``fn`` returns ``(compact, counts)``: the valid entries
of the reference's ``(depth * N,)`` buffer, whose tail is zeros, and
the per-level node counts.

``dryrun_multichip`` (reference ``:39-133``) is ``parallel.dryrun``'s.
"""

from __future__ import annotations

import torch

from .ops import octree as ops
from .parallel.dryrun import _make_codes, dryrun_multichip  # noqa: F401
from .utils.device import resolve as resolve_device

DEPTH = 10
NUM_CODES = 4096


def entry(device=None):
    """``(fn, (codes,))`` with the codes on ``device`` (default: the
    current CUDA device; ``NoDeviceError`` without one)."""
    device = resolve_device(device)

    def fn(codes):
        return ops.encode_analysis_packed(codes, DEPTH, ops.CTX_MODE_PARENT)

    codes = torch.as_tensor(_make_codes(NUM_CODES, DEPTH), device=device)
    return fn, (codes,)
