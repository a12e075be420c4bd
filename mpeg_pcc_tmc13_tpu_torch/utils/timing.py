"""Wall + user-CPU stopwatch (reference pcc_chrono.h:50-90).

The reference times the whole run and each geometry/attribute payload
with a wall clock plus a user-CPU clock including children
(utime_inc_children_clock); `Stopwatch` mirrors that with
time.monotonic + os.times (self+children user time).
"""

from __future__ import annotations

import os
import time


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
