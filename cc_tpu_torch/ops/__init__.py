"""Compute ops: resampling, the local correlation cost volume and its
backward, and the row gather."""
