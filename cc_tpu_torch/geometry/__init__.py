"""Geometry: bilinear sampling and flow warping."""
