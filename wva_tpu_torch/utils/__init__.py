"""Shared utilities: the injectable clock and the freeze mixin."""

from wva_tpu_torch.utils.clock import SYSTEM_CLOCK, Clock, FakeClock

__all__ = ["SYSTEM_CLOCK", "Clock", "FakeClock"]
