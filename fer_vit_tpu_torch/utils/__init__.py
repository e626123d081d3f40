"""Metrics, the experiment-dir logger, the profile summary and the
device-init watchdog."""
