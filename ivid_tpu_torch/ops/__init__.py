"""Geometry, rasterization, rendering and attention ops."""
