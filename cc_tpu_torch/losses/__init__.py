"""Losses (this slice carries only spatial_normalize)."""
