"""Checkpoint / resume.

The reference dumps full state every step but has no code path to load one and
resume (SURVEY.md §5 "checkpoint/resume") — this closes that gap. Format:
one ``.npz`` per checkpoint (the state pytree + step counter) plus the params
JSON, in ``<dir>/ckpt_<step>.npz``. Orbax is available in this environment but
a dependency-free format keeps checkpoints readable by plain NumPy and by the
reference's tooling conventions.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Optional, Tuple

import numpy as np

from fluid_simulation.config import SimParams
from fluid_simulation.models.windtunnel import FluidState


def save_checkpoint(ckpt_dir: str, state: FluidState, step: int,
                    params: Optional[SimParams] = None,
                    obstacles=None, keep: int = 3) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")
    arrays = {k: np.asarray(v) for k, v in state._asdict().items()}
    if obstacles is not None:
        arrays["obstacles"] = np.asarray(obstacles)
    np.savez_compressed(path, step=step, **arrays)
    if params is not None:
        with open(os.path.join(ckpt_dir, "params.json"), "w") as f:
            f.write(params.to_json())
    # retention: keep the newest `keep` checkpoints
    all_ckpts = sorted(glob.glob(os.path.join(ckpt_dir, "ckpt_*.npz")))
    for old in all_ckpts[:-keep]:
        os.remove(old)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    ckpts = sorted(glob.glob(os.path.join(ckpt_dir, "ckpt_*.npz")))
    return ckpts[-1] if ckpts else None


def load_checkpoint(path_or_dir: str
                    ) -> Tuple[FluidState, int, Optional[SimParams], Optional[np.ndarray]]:
    """Load a checkpoint file (or the latest in a directory).

    Returns ``(state, step, params_or_None, obstacles_or_None)``.
    """
    path = path_or_dir
    if os.path.isdir(path):
        path = latest_checkpoint(path)
        if path is None:
            raise FileNotFoundError(f"no checkpoints in {path_or_dir}")
    with np.load(path) as z:
        # NumPy leaves on purpose: they become device arrays when first passed
        # into a jitted step, on whatever device that step runs.
        state = FluidState(
            vx=np.array(z["vx"]), vy=np.array(z["vy"]),
            vz=np.array(z["vz"]), dens=np.array(z["dens"]))
        step = int(z["step"])
        obstacles = np.array(z["obstacles"]) if "obstacles" in z else None
    params = None
    params_path = os.path.join(os.path.dirname(path), "params.json")
    if os.path.exists(params_path):
        with open(params_path) as f:
            params = SimParams.from_json(f.read())
    m = re.match(r".*ckpt_(\d+)\.npz$", path)
    if m:
        step = int(m.group(1))
    return state, step, params, obstacles
