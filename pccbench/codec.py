"""What a codec hands the harness, and the result's ``device``.

A codec is ``pccbench/codecs/<name>.py``, named by the configuration's
``"codec"`` and loaded by file (``spec.Cell.codec``).  It exposes

- ``make(cfg, mix, devices, clock)``: set-up's part, given the
  configuration's dict, the traffic ``Mix``, the cell's ``chips``
  devices and the harness's ``Clock``; it returns an object with
  ``encode(codes, values) -> Encoded`` and ``decode(geom, attr, points)
  -> (codes, values or None)``.  Each side opens the span ``encode`` or
  ``decode`` around all its work and ends it only once its results are
  on the host.  The decoded codes are the frame's whole sorted leaf
  codes, whatever its slices, and the decoded values are in their order;
- ``SPAN_NAMES`` (optional): the further spans it opens, which a traced
  run keeps on the device's timeline.

Only the codecs import the program (``mpeg_pcc_tmc13_tpu_torch``), and
only inside ``make``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class Encoded:
    geom: bytes
    attr: bytes
    q_rows: List[np.ndarray]
    recon: object                     # (N, C) int64 Q13 tensor, or None


def device_description(devices) -> dict:
    """The result's ``device`` for the cell's ``devices``: the peak is
    the caching allocator's on the fullest of them."""
    import torch
    devs = [torch.device(d) for d in devices]
    if devs[0].type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": len(devs),
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(devs[0]),
            "count": len(devs),
            "memory_peak_bytes": max(int(torch.cuda.max_memory_allocated(d))
                                     for d in devs)}
