"""Batch PNG export.

The reference's ``make_pngs.py`` is a stale 2-D-era script: hardcoded 514x258
dims and a ``(-1, h, w)`` reshape that cannot parse the 3-D dump
(make_pngs.py:7-8,42-45 — SURVEY.md §2 C21). This version reads the dump
through the contract reader (meta.json or explicit dims), renders a chosen
z-slice per frame for density / velocity-x / velocity-y with the same
colormaps and ranges, overlays obstacles, and writes
``<out>/{density,velocity_x,velocity_y}/<i>.png``.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from fluid_simulation.io.dump import read_run
from fluid_simulation.viz.colormap import apply_colormap, overlay_obstacle

_GRAY = np.stack([np.arange(256)] * 3, axis=1).astype(np.uint8)[::-1]  # 'Greys'


def _write_png(path: str, rgb: np.ndarray):
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    plt.imsave(path, rgb)


def render_live(wt, steps: int, out_dir: str, every: int = 1,
                z_slice: Optional[int] = None, kind: str = "dens",
                chunk: int = 10) -> int:
    """Simulate and stream *device-rendered* frames: the slice is colormapped
    and obstacle-shaded on the device (viz/slices.render_frame_device) so only
    KB-sized RGB images cross to the host — the BASELINE north-star
    replacement for dumping 11.3 MB raw grids per step. Returns the number of
    images written."""
    import jax.numpy as jnp
    from fluid_simulation.viz.slices import render_frame_device

    os.makedirs(out_dir, exist_ok=True)
    D2 = wt.params.padded_shape[0]
    z = D2 // 2 if z_slice is None else z_slice
    obs = jnp.asarray(wt.obstacles)  # uploaded once; jit input thereafter
    written = 0
    done = 0
    while done < steps:
        n = min(chunk, steps - done)
        _, ys = wt.simulate(steps=n, record=True)
        _, states = ys
        field = getattr(states, kind)
        for i in range(n):
            step_idx = done + i
            if step_idx % every:
                continue
            rgb = np.asarray(render_frame_device(field[i], obs, z, kind))
            _write_png(os.path.join(out_dir, f"{step_idx:05d}.png"), rgb)
            written += 1
        done += n
    return written


def export_pngs(data_dir: str, out_dir: str, z_slice: Optional[int] = None,
                dims: Optional[Tuple[int, int, int]] = None) -> int:
    """Render every frame; returns the number of images written."""
    run = read_run(data_dir, dims=dims)
    n_frames = run["dens"].shape[0]
    D2 = run["dens"].shape[1]
    z = D2 // 2 if z_slice is None else z_slice

    jobs = (
        ("density", run["dens"], (0.0, 0.01), None),
        ("velocity_x", run["vx"], (-10.0, 10.0), _GRAY),
        ("velocity_y", run["vy"], (-1.0, 1.0), _GRAY),
    )
    written = 0
    for name, arr, (vmin, vmax), lut in jobs:
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        for i in range(n_frames):
            rgb = apply_colormap(arr[i, z], vmin, vmax, lut=lut)
            rgb = overlay_obstacle(rgb, run["obs"][min(i, run["obs"].shape[0] - 1), z],
                                   alpha=0.1)
            _write_png(os.path.join(d, f"{i}.png"), rgb)
            written += 1
    return written
