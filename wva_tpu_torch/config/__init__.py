"""Configuration: the SLO service classes and performance profiles
(:mod:`wva_tpu_torch.config.slo`)."""
