"""Visualization: shared colormap, on-device slice rendering, iso-surface
extraction (in-house marching tetrahedra — skimage-free), vectorized
streamlines, PNG export, and the two viewers (PyQt6-gated with headless
fallbacks)."""

from fluid_simulation.viz.colormap import (
    DENSITY_CMAP_COLORS, build_lut, apply_colormap)
from fluid_simulation.viz.slices import render_slice, FIELD_RANGES

__all__ = [
    "DENSITY_CMAP_COLORS",
    "build_lut",
    "apply_colormap",
    "render_slice",
    "FIELD_RANGES",
]
