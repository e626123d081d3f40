"""Metrics and the experiment-dir logger."""
