"""Data-acquisition layer: the SLO arrival-rate window settings, and the
series window the forecast history hands out (``source.promql``)."""
