"""Compute ops: resampling and the local correlation cost volume."""
