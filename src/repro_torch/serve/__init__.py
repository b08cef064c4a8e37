"""Greedy dense-cache serving."""
