"""Metric sources. The port keeps only ``promql.SeriesWindow``'s module, for
the forecast plane's demand history."""
