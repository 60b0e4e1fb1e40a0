"""Geometry & scene preprocessing: STL ingestion, mesh transforms, voxelization,
analytic primitives, and the precomputed boundary/obstacle masks that turn the
reference's per-cell branches into branch-free arithmetic.
"""

from fluid_simulation.scene.masks import SceneMasks, build_masks
from fluid_simulation.scene.primitives import (
    empty_obstacles,
    add_box,
    add_sphere,
    add_cylinder,
)

__all__ = [
    "SceneMasks",
    "build_masks",
    "empty_obstacles",
    "add_box",
    "add_sphere",
    "add_cylinder",
]
