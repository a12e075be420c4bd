"""How ``correct`` is decided: the program's outputs against the plain
reference, each number beside its limit.

- ``geom_codes_wrong`` (every cell): over every frame decoded in the
  window, the positions at which the decoded leaf codes differ from the
  frame's own sorted unique codes, plus the difference in length.  The
  configurations state lossless geometry: limit 0.
- The attribute numbers, where the mix codes attributes: the numbers,
  limits and reference of the configuration's check
  (``pccbench/checks/<check>.py``, ``spec.Cell.check``), over every
  coding in the window of one frame drawn from the seed.

A run is correct where every number is at or under its limit.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

LIMITS = {"geom_codes_wrong": 0}


def geometry_wrong(decoded: np.ndarray, expected: np.ndarray) -> int:
    decoded = np.asarray(decoded).reshape(-1)
    n = min(decoded.size, expected.size)
    return int(np.count_nonzero(decoded[:n] != expected[:n])
               + abs(decoded.size - expected.size))


def passes(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(v <= limits[k] for k, v in numbers.items())


def sample_frame(seed: int, frames_done: int) -> int:
    """The frame whose attributes are judged, drawn from the seed among
    the frames the window coded."""
    rng = np.random.default_rng([seed % (1 << 63), 0x5A4D])
    return int(rng.integers(max(frames_done, 1)))
