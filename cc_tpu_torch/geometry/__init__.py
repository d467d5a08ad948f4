"""Geometry: camera projection, rotations, rigid warps, bilinear sampling."""
