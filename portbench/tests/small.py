"""Cells cut to a size a CPU test run holds: the fleet to a few models,
the emulated world's warm-up to its first minutes. Only the sizes change;
every driver, probe, reference and comparison is the benchmark's own."""

from __future__ import annotations

import contextlib

import torch

from portbench import core

MODELS = 24
WARMUP_S = 240.0


@contextlib.contextmanager
def cells(models: int = MODELS, warmup_s: float = WARMUP_S):
    inner = core.cell
    threads = torch.get_num_threads()

    def cell(name):
        work, config, traffic = inner(name)
        if "n_models" in config:
            config = dict(config, n_models=models)
        if "warmup_s" in traffic:
            traffic = dict(traffic, warmup_s=warmup_s)
        return work, config, traffic

    core.cell = cell
    torch.set_num_threads(1)
    try:
        yield
    finally:
        core.cell = inner
        torch.set_num_threads(threads)
