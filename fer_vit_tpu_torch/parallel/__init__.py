"""Tensor parallelism (:mod:`.sharding`)."""
