"""Precision tuning: the port's artifact loader (the tuner itself is
still to port)."""
