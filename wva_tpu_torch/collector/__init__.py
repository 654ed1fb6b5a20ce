"""Data-acquisition layer: only the SLO arrival-rate window settings so far."""
