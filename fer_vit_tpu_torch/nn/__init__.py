"""Transformer layers."""
