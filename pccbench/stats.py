"""What a metric reader reads: the window's records, the set-up time,
the trace of a traced run, and the arithmetic they share.

Rates are taken over all the frames of the window and the summed walls
of the sides that coded them; a tail over every frame of the window;
per-layer times are a layer's total over the window divided by the
frames.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np

from .frames import Frame
from .spans import Record
from .trace import Trace

PEAKS = json.loads(
    (Path(__file__).resolve().parent / "roofline" / "peaks.json").read_text())


def rate_mpts(points: List[int], walls: List[float]) -> Optional[float]:
    """Million points per second over summed walls."""
    total = float(sum(walls))
    return sum(points) / total / 1e6 if total > 0 else None


def p95(values: List[float]) -> Optional[float]:
    """95th percentile, numpy's linear interpolation."""
    return float(np.percentile(values, 95)) if len(values) else None


@dataclass
class Run:
    records: List[Record]
    frames: List[Frame]
    setup_s: float
    channels: int
    device_kind: str
    trace: Optional[Trace] = None

    def span_total(self, name: str) -> Optional[float]:
        """Seconds of ``name`` over the window; None where no frame has
        the span."""
        vals = [r.spans[name] for r in self.records if name in r.spans]
        return float(sum(vals)) if vals else None

    def counter_total(self, name: str) -> float:
        return float(sum(r.counters.get(name, 0.0) for r in self.records))

    def per_frame_ms(self, seconds: Optional[float]) -> Optional[float]:
        if seconds is None or not self.records:
            return None
        return 1e3 * seconds / len(self.records)

    def side_rate(self, side: str) -> Optional[float]:
        """None where the mix does not time ``side``."""
        timed = [r for r in self.records if side in r.spans]
        return rate_mpts([r.points for r in timed],
                         [r.spans[side] for r in timed])

    def roofline(self, kernel, side: str) -> Optional[float]:
        """Percent of the byte bound at the card's published bandwidth
        over the kernel's device time inside the ``side`` spans; None
        without a trace, a launch or a known peak."""
        peak = PEAKS.get(self.device_kind, {}).get("hbm_bytes_per_s")
        if self.trace is None or peak is None:
            return None
        seconds = self.trace.op_time(kernel.KERNELS, side)
        if seconds <= 0:
            return None
        moved = sum(kernel.bytes_moved(self.frames[r.frame].work,
                                       self.channels, side)
                    for r in self.records)
        return 100.0 * moved / peak / seconds

    def idle_percent(self, side: str) -> Optional[float]:
        if self.trace is None or not self.trace.ops:
            return None
        busy, length = self.trace.busy(side)
        return 100.0 * (1.0 - busy / length) if length > 0 else None
