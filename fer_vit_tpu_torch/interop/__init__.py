"""Weights from the JAX package's variables."""
