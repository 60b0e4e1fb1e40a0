"""Device-mesh construction."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh


def make_mesh(n_devices: Optional[int] = None, batch: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ``('batch', 'z')`` mesh over the first ``n_devices`` devices.

    ``batch=1`` still creates the axis (size 1) so step code is written once.
    The z axis carries the spatial domain decomposition. On a host whose
    cards are joined all to all (NVLink) the device order does not matter.
    """
    devs = list(devices if devices is not None else jax.devices())
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if n % batch != 0:
        raise ValueError(f"{n} devices not divisible by batch={batch}")
    arr = np.array(devs).reshape(batch, n // batch)
    return Mesh(arr, axis_names=("batch", "z"))
