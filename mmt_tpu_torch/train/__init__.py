"""Training-side utilities (metrics) of the port."""
