"""Injectable clock.

The reference uses wall time everywhere; this framework routes all engine /
cache / metrics timing through a Clock so the emulation harness and bench can
run discrete-event simulations (hours of autoscaling in milliseconds) — the
TPU-build equivalent of the reference's multi-minute kind e2e waits.
"""

from __future__ import annotations

import threading
import time as _time


class Clock:
    """Real wall clock."""

    def now(self) -> float:
        return _time.time()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            _time.sleep(seconds)


class FakeClock(Clock):
    """Manually-advanced clock for single-threaded discrete-event simulation:
    ``sleep`` advances time immediately. Not a multi-threaded waiter — the
    emulation harness drives all components from one loop."""

    def __init__(self, start: float = 0.0) -> None:
        self._mu = threading.Lock()
        self._now = start

    def now(self) -> float:
        with self._mu:
            return self._now

    def sleep(self, seconds: float) -> None:
        # In single-threaded simulation, sleeping IS advancing.
        self.advance(seconds)

    def advance(self, seconds: float) -> None:
        with self._mu:
            self._now += seconds

    def set(self, t: float) -> None:
        with self._mu:
            self._now = max(self._now, t)


SYSTEM_CLOCK = Clock()
