"""Training: losses, schedulers, the harness, the fit loop and the CLIs."""
