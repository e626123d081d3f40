"""Metrics, the experiment-dir logger, the profile summary, the
profiler spans and the device-init watchdog."""
