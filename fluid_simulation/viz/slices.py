"""Z-slice rendering, host and on-device.

The 2-D viewer's display pipeline (gui.py:257-317): pick a z-slice of one
field, colormap it with fixed per-field ranges — density [0, 0.01], vx ±10,
vy/vz ±1 (gui.py:271-289) — then darken obstacle pixels (alpha 0.2).

``render_slice`` is the host path (NumPy). ``render_frame_device`` performs
colormap + overlay *on the device* (a 256-entry LUT gather fused into the jitted
step), so a GUI can stream KB-sized RGB images instead of the reference's
11.3 MB raw frames (BASELINE.json north-star: "on-device slice colormapping
so the PyQt GUI reads rendered frames, not raw grids").
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from fluid_simulation.viz.colormap import (
    apply_colormap, build_lut, overlay_obstacle)

# per-field display ranges (gui.py:273-289)
FIELD_RANGES = {
    "dens": (0.0, 0.01),
    "vx": (-10.0, 10.0),
    "vy": (-1.0, 1.0),
    "vz": (-1.0, 1.0),
}


def render_slice(field: np.ndarray, obs: np.ndarray, z: int,
                 kind: str = "dens", alpha: float = 0.2) -> np.ndarray:
    """(H+2, W+2, 3) uint8 image of one z-slice with obstacle overlay."""
    vmin, vmax = FIELD_RANGES[kind]
    rgb = apply_colormap(np.asarray(field)[z], vmin, vmax)
    return overlay_obstacle(rgb, np.asarray(obs)[z], alpha=alpha)


def colormap_slice(sl: jnp.ndarray, obs_sl: jnp.ndarray,
                   kind: str = "dens") -> jnp.ndarray:
    """Traceable core: one 2-D plane -> RGB uint8 with obstacle shading.
    Usable inside jit/shard_map (ShardedWindTunnel.render_slice renders the
    owning rank's plane with this)."""
    vmin, vmax = FIELD_RANGES[kind]
    lut = jnp.asarray(build_lut())  # (256, 3) uint8, constant-folded
    t = jnp.clip((sl.astype(jnp.float32) - vmin) / (vmax - vmin), 0.0, 1.0)
    idx = (t * 255.0 + 0.5).astype(jnp.int32)
    rgb = lut[idx]  # gather -> (H+2, W+2, 3)
    dark = (rgb.astype(jnp.float32) * 0.8).astype(jnp.uint8)
    solid = (obs_sl > 0.5)[..., None]
    return jnp.where(solid, dark, rgb)


@functools.partial(jax.jit, static_argnames=("kind", "z"))
def render_frame_device(field: jnp.ndarray, obs: jnp.ndarray,
                        z: int, kind: str = "dens") -> jnp.ndarray:
    """On-device slice -> RGB uint8. Jitted; safe to fetch (tiny)."""
    return colormap_slice(field[z], obs[z], kind)
