"""Tensor Processing Primitives (the subset the serving path uses)."""
