"""The measured window: one general loop, driven by a traffic mix's data
file, ``pccbench/traffic/<traffic>.json``.  A mix sets

- ``attributes`` (true or false): whether each frame's attribute stream
  is coded beside its geometry stream;
- ``sides``: the sides the window times, ``["encode", "decode"]`` (a
  transcoder followed by a player) or ``["decode"]`` (a player: set-up
  encodes every frame once, and the window decodes their streams);
- ``arrival_hz``: 0 for a closed loop, where each frame starts as the
  one before it ends; above 0, an open loop in which frame k arrives
  k / ``arrival_hz`` seconds into the window and waits for the coder
  until those before it are done.  Every frame that arrives before the
  window closes is coded, the last ones perhaps after the close.

Frames are coded in turn, cycling through the configuration's.  Each
coded frame gets a ``Record`` (``spans.py``) with its spans, counters,
payload, times of arrival and completion, and the number of its decoded
leaf codes that differ from its own, counted outside the sides' spans.
Of the frame that ``check.sample_frame`` drew, each coding's attribute
outputs, as the configuration's check takes them (its ``outputs``), are
kept for the reference to judge after the window.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

from . import check
from .spans import Clock, Record

SIDES = (("encode", "decode"), ("decode",))


@dataclass(frozen=True)
class Mix:
    attributes: bool
    sides: Tuple[str, ...]
    arrival_hz: float

    @classmethod
    def from_data(cls, data: dict) -> "Mix":
        """The mix of a traffic file's parameters; ValueError for a key
        or a value that the loop does not know."""
        unknown = set(data) - {"attributes", "sides", "arrival_hz"}
        if unknown:
            raise ValueError(f"unknown traffic keys {sorted(unknown)}")
        sides = tuple(data.get("sides", SIDES[0]))
        if sides not in SIDES:
            raise ValueError(f"sides {list(sides)}: one of {SIDES}")
        hz = float(data.get("arrival_hz", 0))
        if hz < 0:
            raise ValueError("arrival_hz must be 0 (closed) or above")
        return cls(bool(data["attributes"]), sides, hz)

    @property
    def times_encode(self) -> bool:
        return "encode" in self.sides


class Window:
    def __init__(self, codec, frames, mix: Mix, clock: Clock, sample: int,
                 outputs: Optional[Callable]):
        """``outputs(encoded, values)``: what the check keeps of a coding
        of the sampled frame (unused where the mix codes no
        attributes)."""
        self.codec, self.frames, self.mix = codec, frames, mix
        self.clock, self.sample = clock, sample
        self.outputs = outputs
        self.streams = None

    def warm(self) -> None:
        """Set-up's part: the streams of a mix that does not time the
        encoder, then one untimed coding of the largest frame, which
        warms the caching allocator and loads (or, in a checkout's first
        run, builds) the kernels."""
        codec = self.codec
        if not self.mix.times_encode:
            self.streams = [codec.encode(fr.codes, fr.values)
                            for fr in self.frames]
        f, fr = max(enumerate(self.frames), key=lambda x: x[1].points)
        e = self._stream(f)
        codec.decode(e.geom, e.attr, fr.points)

    def _stream(self, f: int):
        fr = self.frames[f]
        if self.streams is not None:
            return self.streams[f]
        return self.codec.encode(fr.codes, fr.values)

    def run(self, seconds: float) -> Tuple[List[Record], List[dict]]:
        """(a record for each frame coded, the kept outputs of the
        sampled frame's codings)."""
        records, kept = [], []
        hz = self.mix.arrival_hz
        t0 = time.perf_counter()
        with self.clock.span("window"):
            while True:
                k = len(records)
                now = time.perf_counter() - t0
                if hz > 0:
                    arrival = k / hz
                    if arrival >= seconds:
                        break
                    if now < arrival:
                        time.sleep(arrival - now)
                        now = time.perf_counter() - t0
                elif now >= seconds:
                    break
                else:
                    arrival = now
                rec, out = self._code(k % len(self.frames), t0)
                rec.arrival_s, rec.start_s = arrival, now
                records.append(rec)
                if out is not None:
                    kept.append(out)
        return records, kept

    def judge_late(self) -> Optional[dict]:
        """The sampled frame's outputs from one coding after the window,
        where the window closed before it came round (a window shorter
        than the configuration's frames)."""
        return self._code(self.sample, time.perf_counter(), False)[1]

    def _code(self, f: int, t0: float, timed: bool = True):
        fr, clock = self.frames[f], self.clock
        rec = Record(frame=f, points=fr.points)
        clock.record = rec if timed else None
        e = self._stream(f)
        rec.encoded_s = time.perf_counter() - t0
        codes, values = self.codec.decode(e.geom, e.attr, fr.points)
        rec.done_s = time.perf_counter() - t0
        clock.record = None
        rec.payload_bytes = len(e.geom) + len(e.attr)
        rec.geom_wrong = check.geometry_wrong(codes, fr.codes)
        out = None
        if self.mix.attributes and f == self.sample:
            out = self.outputs(e, values)
        return rec, out
