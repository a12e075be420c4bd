"""The device trace of a ``--trace 1`` run, reduced to intervals.

``torch.profiler`` records the window with CPU and CUDA activity; its
Chrome trace holds the device's operations (kernels, copies, sets) and
the harness's spans (``record_function`` ranges) on one timeline.  This
module keeps both as (name, start, end) in seconds and answers what the
per-layer readers ask: a kernel's device time inside a side's spans, the
share of a side that no device operation covers, the busiest operations
and the longest idle gaps by the span the host was in.
"""

from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass
from typing import Iterable, List, Sequence, Tuple

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
Interval = Tuple[str, float, float]


def _short(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace,
    argument list or template arguments."""
    name = name.strip()
    if name.startswith("void "):
        name = name[len("void "):]
    name = name.replace("(anonymous namespace)::", "")
    for cut in ("(", "<"):
        i = name.find(cut)
        if i > 0:
            name = name[:i]
    return name.strip()


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def overlap(cover: Sequence[Tuple[float, float]], starts: np.ndarray,
            a: float, b: float) -> float:
    """Seconds of [a, b] that the sorted disjoint ``cover`` (whose starts
    are ``starts``) covers."""
    if not cover:
        return 0.0
    i = max(int(np.searchsorted(starts, a, side="right")) - 1, 0)
    tot = 0.0
    while i < len(cover) and cover[i][0] < b:
        tot += max(0.0, min(b, cover[i][1]) - max(a, cover[i][0]))
        i += 1
    return tot


@dataclass
class Trace:
    ops: List[Interval]               # device operations
    spans: List[Interval]             # the harness's spans

    @classmethod
    def from_chrome(cls, path, span_names: Iterable[str]) -> "Trace":
        with open(path) as f:
            events = json.load(f)
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        names = set(span_names)
        ops, spans = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = str(e.get("cat", "")).lower()
            start = float(e["ts"]) * 1e-6
            end = start + float(e["dur"]) * 1e-6
            if cat in DEVICE_CATS:
                ops.append((_short(str(e.get("name", ""))), start, end))
            elif cat == "user_annotation" and e.get("name") in names:
                spans.append((e["name"], start, end))
        ops.sort(key=lambda t: t[1])
        spans.sort(key=lambda t: t[1])
        return cls(ops, spans)

    def spans_named(self, name: str) -> List[Tuple[float, float]]:
        return [(a, b) for n, a, b in self.spans if n == name]

    def op_time(self, kernels: Sequence[str], side: str) -> float:
        """Summed device seconds of the operations whose name holds one
        of ``kernels`` and that start inside a ``side`` span."""
        within = self.spans_named(side)
        starts = np.array([a for a, _ in within])
        tot = 0.0
        for name, a, b in self.ops:
            if not within or not any(k in name for k in kernels):
                continue
            i = int(np.searchsorted(starts, a, side="right")) - 1
            if i >= 0 and a <= within[i][1]:
                tot += b - a
        return tot

    def busy(self, side: str) -> Tuple[float, float]:
        """(seconds a device operation covers, seconds) of the ``side``
        spans."""
        cover = union((a, b) for _, a, b in self.ops)
        starts = np.array([a for a, _ in cover])
        within = self.spans_named(side)
        length = sum(b - a for a, b in within)
        return sum(overlap(cover, starts, a, b) for a, b in within), length

    def device_ops(self, top: int = 10) -> List[list]:
        tot = defaultdict(float)
        for name, a, b in self.ops:
            tot[name] += b - a
        return [[n, s] for n, s in
                sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, window: str = "window", top: int = 10) -> List[list]:
        """Idle device seconds inside the window, split by the innermost
        span open at each moment (the window itself where none is)."""
        win = self.spans_named(window)
        if not win:
            return []
        lo, hi = win[0][0], win[-1][1]
        cover = union((a, b) for _, a, b in self.ops)
        cover_starts = np.array([a for a, _ in cover])
        inner = [s for s in self.spans if s[0] != window]
        starts = np.array([s[1] for s in inner])
        cuts = sorted({lo, hi} | {t for _, a, b in inner for t in (a, b)
                                  if lo < t < hi})
        tot = defaultdict(float)
        for a, b in zip(cuts[:-1], cuts[1:]):
            # spans nest, so the open span that started last is the
            # innermost; a frame holds a few tens of spans
            mid = 0.5 * (a + b)
            best = window
            i = int(np.searchsorted(starts, mid, side="right")) - 1
            for j in range(i, max(i - 64, -1), -1):
                if inner[j][2] >= mid:
                    best = inner[j][0]
                    break
            tot[best] += (b - a) - overlap(cover, cover_starts, a, b)
        return [[n, s] for n, s in
                sorted(tot.items(), key=lambda kv: -kv[1])[:top]
                if s > 0]
