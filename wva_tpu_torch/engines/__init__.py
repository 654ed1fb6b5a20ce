"""Engines: the staged SLO sizing pass of the engine tick
(:mod:`wva_tpu_torch.engines.slo_pass`)."""
