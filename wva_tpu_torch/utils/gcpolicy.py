"""The port's policy for the interpreter's cyclic garbage collector.

A fleet-width engine tick allocates some hundreds of thousands of tracked
objects that live about as long as the tick (the collector cache's values,
the metric results, the decision steps), over a standing heap of some
650,000 (the informer's copies of every VariantAutoscaling, Deployment and
Pod, the config, the profiles, the planner's history). Under the
interpreter's thresholds (700, 10, 10) that per-tick state survives the
young collections into generation 2, and the full collections it triggers
walk the whole standing heap to free nothing: the program makes no cyclic
garbage in steady state.

So, after a completed engine tick, the policy reads what the tick cost the
collector. Where two ticks in a row each made enough net tracked
allocations for ``ENGAGE_YOUNG`` young collections at the interpreter's
threshold 0, it engages, once per process: one ``gc.collect()``, then
``gc.freeze()``, which takes every object alive from the collector's view.
From then on it sizes threshold 0 to the tick, so that a tick runs about
``TARGET_YOUNG`` young collections, never below the interpreter's threshold
and never above ``YOUNG_CAP``; thresholds 1 and 2 stay as they were. A
small fleet or a one-model world never engages it. The collector is never
disabled and collects nothing outside a tick: the one ``gc.collect()`` runs
inside the tick that engages the policy. Nothing in the program keeps weak
references or defines ``__del__``, so freezing changes no result, only when
the memory of cyclic garbage would be reclaimed.

The collector is the process's, so is the policy's state: each Manager
holds a ``GcPolicy``, and the engaged ones count as owners. The last owner
to release (``Manager.shutdown``) calls ``gc.unfreeze()`` and restores the
thresholds that were there before the first engaged. CPython 3.12 keeps its
immortal objects (some hundreds of static tuples, from start-up) in the
frozen generation; ``gc.unfreeze()`` hands them back with the rest, and
the next collection of generation 2 parks them there again.
"""

from __future__ import annotations

import gc
import threading
from typing import Callable

# The cut-off: a tick is heavy when its net tracked allocations would run
# at least this many young collections at the interpreter's threshold 0
# (700: 35,000 allocations). A 1,000-model fleet tick runs about 400, a
# 250-model one about 70; a one-model world's tick fewer than 1, and a
# 24-model fleet's 2-4 (28 on its first tick).
ENGAGE_YOUNG = 50
# Heavy ticks in a row before the policy engages: a world's one cold tick
# (first imports, first kernel builds) can be heavy alone.
ENGAGE_TICKS = 2
# Young collections a tick once engaged (threshold 0 follows the tick).
TARGET_YOUNG = 10
# The largest threshold 0: a young collection walks at most about this many
# objects (a few ms).
YOUNG_CAP = 50_000

_LOCK = threading.Lock()
_owners = 0
_saved_thresholds: tuple[int, int, int] | None = None
# Objects frozen at the engagement, while the heap is held frozen.
_frozen: int | None = None


def _collections() -> tuple[int, int]:
    """(young, full) collections the interpreter has run: generations 0
    and 1, and generation 2."""
    stats = gc.get_stats()
    return (stats[0]["collections"] + stats[1]["collections"],
            stats[2]["collections"])


def _default_threshold0() -> int:
    """The interpreter's threshold 0 as it was before any policy engaged."""
    with _LOCK:
        saved = _saved_thresholds
    return (saved or gc.get_threshold())[0]


def _engage() -> None:
    global _owners, _saved_thresholds, _frozen
    with _LOCK:
        if _owners == 0:
            _saved_thresholds = gc.get_threshold()
            gc.collect()
            gc.freeze()
            _frozen = gc.get_freeze_count()
        _owners += 1


def _release() -> None:
    global _owners, _saved_thresholds, _frozen
    with _LOCK:
        _owners -= 1
        if _owners == 0:
            gc.unfreeze()
            gc.set_threshold(*_saved_thresholds)
            _saved_thresholds = _frozen = None


def frozen() -> int:
    """Objects in the frozen generation: while a policy holds the heap
    frozen, as many as it froze (fewer remain as they die). CPython counts
    the frozen generation by walking it, some ms at fleet width, so the
    policy counts once, at the freeze."""
    with _LOCK:
        count = _frozen
    return gc.get_freeze_count() if count is None else count


def owners() -> int:
    """Engaged policies in this process."""
    with _LOCK:
        return _owners


class GcPolicy:
    """One Manager's share of the collector policy: the engine calls
    ``begin_tick`` as a tick starts and puts ``tick_attrs`` on the tick's
    span; ``observe`` wraps the executor's tick observer; the Manager's
    shutdown calls ``release``."""

    def __init__(self) -> None:
        self.engaged = False
        self._released = False
        self._heavy = 0
        # Orders a tick's engagement and sizing against ``release`` (the
        # engine's thread and the one that shuts the Manager down).
        self._mu = threading.Lock()
        # At the tick's start: (young, full, threshold 0, generation 0's
        # count), or None outside a tick.
        self._start: tuple[int, int, int, int] | None = None

    def begin_tick(self) -> None:
        young, full = _collections()
        self._start = (young, full, gc.get_threshold()[0], gc.get_count()[0])

    def _since_start(self) -> tuple[int, int, int]:
        """(young, full, net tracked allocations) since the tick's start.
        Every collection the allocations trigger comes after threshold 0's
        worth of them, and resets generation 0's count."""
        young0, full0, threshold0, count0 = self._start
        young, full = _collections()
        young, full = young - young0, full - full0
        net = (young + full) * threshold0 + gc.get_count()[0] - count0
        return young, full, net

    def tick_attrs(self) -> dict[str, int]:
        """The tick span's counters: the young and full collections run
        since the tick's start, and the objects frozen (``frozen``)."""
        if self._start is None:
            young = full = 0
        else:
            young, full, _ = self._since_start()
        return {"gc_young": young, "gc_full": full, "gc_frozen": frozen()}

    def after_tick(self) -> None:
        """Engage after the second heavy tick in a row; once engaged, size
        threshold 0 to the tick just run."""
        if self._start is None:
            return
        _, _, net = self._since_start()
        self._start = None
        default = _default_threshold0()
        with self._mu:
            if self._released:
                return
            if not self.engaged:
                heavy = net >= ENGAGE_YOUNG * default
                self._heavy = self._heavy + 1 if heavy else 0
                if self._heavy < ENGAGE_TICKS:
                    return
                _engage()
                self.engaged = True
            threshold0 = min(max(net // TARGET_YOUNG, default), YOUNG_CAP)
            gc.set_threshold(threshold0, *gc.get_threshold()[1:])

    def observe(self, inner: Callable[[str, float, bool], None] | None
                ) -> Callable[[str, float, bool], None]:
        """An executor tick observer that runs the policy, then ``inner``."""
        def on_tick(name: str, elapsed: float, ok: bool) -> None:
            self.after_tick()
            if inner is not None:
                inner(name, elapsed, ok)

        return on_tick

    def release(self) -> None:
        """Give up this Manager's share for good (idempotent; later ticks
        leave the collector alone); the last owner thaws the heap and
        restores the thresholds."""
        with self._mu:
            self._released = True
            if self.engaged:
                self.engaged = False
                _release()
