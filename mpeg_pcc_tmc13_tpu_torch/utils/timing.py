"""Wall + user-CPU stopwatch (reference pcc_chrono.h:50-90), and the
codec's tracer.

The reference times the whole run and each geometry/attribute payload
with a wall clock plus a user-CPU clock including children
(utime_inc_children_clock); `Stopwatch` mirrors that with
time.monotonic + os.times (self+children user time).

The tracer names the host stages of the codec.  It is off unless a
caller installs a sink with ``tracing``: then each ``span`` is a
``torch.profiler.record_function`` range named ``<scope>.<name>``, on
the profiler's timeline beside the device's kernels and copies, and its
perf_counter seconds add to ``sink.spans[<scope>.<name>]``; ``count``
and ``counted`` add to ``sink.counters`` with no range (parts of a
loop).  A sink is any object with ``spans`` and ``counters`` dicts.
Off, ``span`` and ``counted`` return one shared no-op object and
``count`` returns at once: no clock read, no allocation, no import.
The sink is one for the process, so a span opened on a worker thread
records into it too, and its range stays on that thread.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager


class Stopwatch:
    def __init__(self):
        self.wall = 0.0
        self.user = 0.0
        self._t0 = None
        self._u0 = None

    @staticmethod
    def _user_now() -> float:
        t = os.times()
        return t.user + t.children_user

    def start(self):
        self._t0 = time.monotonic()
        self._u0 = self._user_now()
        return self

    def stop(self):
        if self._t0 is not None:
            self.wall += time.monotonic() - self._t0
            self.user += self._user_now() - self._u0
            self._t0 = None
        return self

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


_sink = None          # the installed sink; None: tracing is off
_prefix = ""          # "<scope>." or ""


@contextmanager
def tracing(sink, scope: str = ""):
    """Record the block's spans and counters into ``sink``, each name
    prefixed ``<scope>.``; the sink and scope before are back on exit."""
    global _sink, _prefix
    before = _sink, _prefix
    _sink, _prefix = sink, f"{scope}." if scope else ""
    try:
        yield sink
    finally:
        _sink, _prefix = before


def count(name: str, value: float) -> None:
    """Add ``value`` to the counter ``name``."""
    if _sink is not None:
        counters, key = _sink.counters, _prefix + name
        counters[key] = counters.get(key, 0.0) + value


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Clocked:
    """A perf_counter pair; ``seconds`` once the block has ended."""
    __slots__ = ("seconds", "_t0")

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        return False


class _Span(_Clocked):
    __slots__ = ("_name", "_spans", "_range")

    def __init__(self, name, spans):
        self._name, self._spans = name, spans

    def __enter__(self):
        from torch.profiler import record_function
        self._range = record_function(self._name)
        self._range.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__()
        self._range.__exit__(*exc)
        spans, name = self._spans, self._name
        spans[name] = spans.get(name, 0.0) + self.seconds
        return False


class _Counted(_Clocked):
    __slots__ = ("_name",)

    def __init__(self, name):
        self._name = name

    def __exit__(self, *exc):
        super().__exit__()
        count(self._name, self.seconds)
        return False


def span(name: str):
    """A stage: a profiler range and its seconds while tracing."""
    if _sink is None:
        return _OFF
    return _Span(_prefix + name, _sink.spans)


def timed(name: str):
    """``span`` whose ``seconds`` are read whether tracing is on or not,
    for a caller that keeps its own total of the same work: the one
    perf_counter pair fills both."""
    if _sink is None:
        return _Clocked()
    return _Span(_prefix + name, _sink.spans)


def counted(name: str):
    """A part of a loop: its seconds add to the counter ``name`` while
    tracing, with no profiler range."""
    if _sink is None:
        return _OFF
    return _Counted(name)
