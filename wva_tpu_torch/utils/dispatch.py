"""Process-wide device-dispatch accounting.

Every call site that launches a compiled XLA executable (the batched
sizing call, the forecast fit, the fleet candidate builder's two passes,
the fused decision program) notes itself here, so `make bench-analyze`
can report *dispatches per tick* as a measured quantity instead of a
claim. Pure Python, no JAX import — the counter must stay importable
from the JAX-free replay CLI paths.
"""

from __future__ import annotations

import threading

_mu = threading.Lock()
_count = 0


def note(n: int = 1) -> None:
    """Record ``n`` device dispatches."""
    global _count
    with _mu:
        _count += n


def count() -> int:
    """Total dispatches noted since process start (monotonic; consumers
    take deltas)."""
    with _mu:
        return _count
