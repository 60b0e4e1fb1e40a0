"""Vectorized streamline generation.

Semantics follow the 3-D viewer (GUI/utils.py:83-214): seeds on a
``density x density/2 x density/2`` grid, bidirectional normalized-Euler
integration with fixed step size, stopping on slow flow (<1e-6), NaN/Inf,
leaving ``[1, dim-1)``, or entering an obstacle; then filters — seeds culled
outside the obstacle bounding box (+proximity/10 pad), seeds inside obstacles,
streamlines with <=5 points, max velocity-change below threshold, and lines
never entering the padded obstacle bbox. Color = max speed along the line,
normalized by the global max velocity component, through the shared colormap.

The reference integrates each seed in a Python triple loop (its hot host-side
path, SURVEY.md §3.3); here all seeds advance together as (S, 3) arrays with
an active mask — typically ~100x faster and the same trajectories.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from fluid_simulation.config import ViewerParams
from fluid_simulation.viz.colormap import build_lut


def _trilinear(grid: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Batch trilinear sampling, clamped like GUI/utils.py:40-74."""
    shape = np.asarray(grid.shape, dtype=np.float64)
    p = np.clip(pts, 0.0, shape - 1.001)
    i0 = p.astype(np.int64)
    f = p - i0
    x0, y0, z0 = i0[:, 0], i0[:, 1], i0[:, 2]
    x1, y1, z1 = x0 + 1, y0 + 1, z0 + 1
    fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]
    c000 = grid[x0, y0, z0]; c100 = grid[x1, y0, z0]
    c010 = grid[x0, y1, z0]; c110 = grid[x1, y1, z0]
    c001 = grid[x0, y0, z1]; c101 = grid[x1, y0, z1]
    c011 = grid[x0, y1, z1]; c111 = grid[x1, y1, z1]
    c00 = c000 * (1 - fx) + c100 * fx
    c01 = c001 * (1 - fx) + c101 * fx
    c10 = c010 * (1 - fx) + c110 * fx
    c11 = c011 * (1 - fx) + c111 * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def _sample_vel(vx, vy, vz, pts):
    return np.stack([_trilinear(vx, pts), _trilinear(vy, pts),
                     _trilinear(vz, pts)], axis=1)


def _integrate(seeds: np.ndarray, vx, vy, vz, obs, max_steps: int,
               direction: float, step_size: float, dims) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """March all seeds together; returns (points (S, T+1, 3),
    velocities (S, T+1, 3), lengths (S,))."""
    S = len(seeds)
    pts = np.full((S, max_steps + 1, 3), np.nan, dtype=np.float64)
    vels = np.zeros((S, max_steps + 1, 3), dtype=np.float64)
    pos = seeds.astype(np.float64).copy()
    pts[:, 0] = pos
    vels[:, 0] = _sample_vel(vx, vy, vz, pos)
    lengths = np.ones(S, dtype=np.int64)
    active = np.ones(S, dtype=bool)
    W, H, D = dims
    for t in range(max_steps):
        if not active.any():
            break
        vec = _sample_vel(vx, vy, vz, pos)
        speed = np.linalg.norm(vec, axis=1)
        active &= speed >= 1e-6
        step = direction * (vec / np.maximum(speed, 1e-30)[:, None]) * step_size
        nxt = pos + step
        ok = np.isfinite(nxt).all(axis=1)
        ok &= ((nxt[:, 0] >= 1) & (nxt[:, 0] < W - 1)
               & (nxt[:, 1] >= 1) & (nxt[:, 1] < H - 1)
               & (nxt[:, 2] >= 1) & (nxt[:, 2] < D - 1))
        safe = np.where(ok[:, None], nxt, 1.0)
        ok &= _trilinear(obs, safe) <= 0.5
        active &= ok
        pos = np.where(active[:, None], nxt, pos)
        pts[active, t + 1] = pos[active]
        vels[active, t + 1] = vec[active]
        lengths[active] += 1
    return pts, vels, lengths


def generate_streamlines(vx, vy, vz, obs_data,
                         params: ViewerParams = None
                         ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """GUI/utils.py:118-214 contract: (streamlines, colors). Arrays are in
    (x, y, z) axis order like the viewer passes them (transposed padded
    grids, GUI/main_window.py:227-231)."""
    p = params or ViewerParams()
    W, H, D = obs_data.shape

    solid_idx = np.argwhere(obs_data > 0.5)
    if len(solid_idx) == 0:
        return [], []
    pad = p.streamline_proximity / 10.0
    bb_lo = solid_idx.min(axis=0) - pad
    bb_hi = solid_idx.max(axis=0) + pad

    xs = np.linspace(1, W - 2, p.streamline_density)
    ys = np.linspace(1, H - 2, p.streamline_density // 2)
    zs = np.linspace(1, D - 2, p.streamline_density // 2)
    Zs, Ys, Xs = np.meshgrid(zs, ys, xs, indexing="ij")
    seeds = np.stack([Xs.ravel(), Ys.ravel(), Zs.ravel()], axis=1)

    inside_bb = ((seeds >= bb_lo) & (seeds <= bb_hi)).all(axis=1)
    seeds = seeds[inside_bb]
    if len(seeds) == 0:
        return [], []
    si = seeds.astype(np.int64)
    seeds = seeds[obs_data[si[:, 0], si[:, 1], si[:, 2]] <= 0.5]
    if len(seeds) == 0:
        return [], []

    half = p.integration_steps // 2
    bp, bv, bl = _integrate(seeds, vx, vy, vz, obs_data, half, -1.0,
                            p.integration_step_size, (W, H, D))
    fp, fv, fl = _integrate(seeds, vx, vy, vz, obs_data, half, +1.0,
                            p.integration_step_size, (W, H, D))

    vmax_all = float(np.max([vx, vy, vz])) + 1e-6
    lut = build_lut()
    lines, colors = [], []
    for i in range(len(seeds)):
        back = bp[i, :bl[i]][::-1]
        backv = bv[i, :bl[i]][::-1]
        line = np.concatenate([back[:-1], fp[i, :fl[i]]], axis=0)
        vel = np.concatenate([backv[:-1], fv[i, :fl[i]]], axis=0)
        if len(line) <= 5:
            continue
        dv = np.linalg.norm(np.diff(vel, axis=0), axis=1)
        if dv.size == 0 or dv.max() < p.velocity_change_threshold:
            continue
        sub = line[::3]
        near = ((sub >= bb_lo) & (sub <= bb_hi)).all(axis=1).any()
        if not near:
            continue
        speed = np.linalg.norm(vel, axis=1).max()
        t = min(speed / vmax_all, 1.0)
        rgba = np.empty(4, dtype=np.float64)
        rgba[:3] = lut[int(t * 255)] / 255.0
        rgba[3] = 1.0
        colors.append(rgba)
        lines.append(line)
    return lines, colors
