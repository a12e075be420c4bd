"""Spans and counters that the harness records around its calls into the
program's layers.

Each coded frame gets a ``Record``: the seconds of every span (summed
where a span repeats within the frame), the counters read from the
program (``PipelineStats.host_entropy_s``) or timed in the harness's own
callbacks, and when it arrived, started and ended in the window.  In a traced run every span is also a
``torch.profiler.record_function`` range, so the trace places it on the
same timeline as the device's operations.
"""

from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class Record:
    frame: int                        # index of the frame coded
    points: int
    spans: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)
    payload_bytes: int = 0
    arrival_s: float = 0.0            # seconds into the window: arrival,
    start_s: float = 0.0              # start of coding,
    encoded_s: float = 0.0            # the encode side's end,
    done_s: float = 0.0               # the decode side's end
    geom_wrong: int = 0               # decoded leaf codes that differ

    def add(self, name: str, value: float) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value


class Clock:
    """Host-clock spans into the current ``Record``."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.record: Optional[Record] = None

    @contextmanager
    def span(self, name: str):
        if self.traced:
            import torch
            ctx = torch.profiler.record_function(name)
        else:
            ctx = nullcontext()
        with ctx:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                if self.record is not None:
                    spans = self.record.spans
                    spans[name] = spans.get(name, 0.0) + dt

    def timed(self, counter: str, fn):
        """``fn`` with its seconds added to the record's ``counter``."""
        def wrapped(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                if self.record is not None:
                    self.record.add(counter, time.perf_counter() - t0)
        return wrapped
