"""Scaling analyzers. The port has the SLO queueing-model analyzer
(:mod:`wva_tpu_torch.analyzers.queueing`) and the demand-trend estimator."""
