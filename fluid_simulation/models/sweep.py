"""Batched design sweeps via ``vmap`` (BASELINE config 4).

The reference can simulate one geometry per process run. Because the rebuilt
step is a pure function of ``(state, masks)``, a batch of obstacle geometries
is just a leading axis — XLA turns the whole sweep into one program with
batched stencils: data parallelism over scenes on one device.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import jax
import jax.numpy as jnp

from fluid_simulation.config import SimParams
from fluid_simulation.models.windtunnel import (
    FluidState, init_state, simulation_step)
from fluid_simulation.scene.masks import build_masks


def batch_masks(obstacle_list: Sequence[np.ndarray]):
    """Stack per-geometry masks into one batched SceneMasks pytree (NumPy
    leaves; they move to the device when passed to ``design_sweep``)."""
    masks = [build_masks(np.asarray(o, np.float32)) for o in obstacle_list]
    return jax.tree_util.tree_map(
        lambda *xs: np.stack([np.asarray(x) for x in xs]), *masks)


# 'auto' takes vmap up to this many interior cells and map above it. One
# H100 (400 W limit), B=8 split, ms per batched step: 128x64x64 vmap 8.82,
# map 9.95; 256x128x128 vmap 69.08, map 49.08. The crossover lies between
# the two grids and was not measured.
SWEEP_VMAP_MAX_CELLS = 128 * 64 * 64


def auto_route(params: SimParams) -> str:
    """The route ``design_sweep(route='auto')`` takes for this grid."""
    return "vmap" if params.n_cells <= SWEEP_VMAP_MAX_CELLS else "map"


@functools.partial(jax.jit, static_argnames=("params", "steps", "route"))
def design_sweep(batched_masks, params: SimParams, steps: int,
                 route: str = "auto"):
    """Simulate ``B`` geometries for ``steps`` steps in ONE compiled program.

    Returns ``(final_states, stats)``: states carry a leading batch axis,
    stats are ``(steps, B)``. Pair with a ``('batch',)`` mesh axis
    (parallel/) to spread geometries across chips.

    ``route`` picks how the batch axis is executed:

    - ``'vmap'``: one vmapped step, the whole batch advances together.
    - ``'map'``: ``lax.map`` over geometries; O(1) compile.
    - ``'auto'`` (default): ``auto_route`` — vmap up to
      ``SWEEP_VMAP_MAX_CELLS`` interior cells, map above (timings beside the
      constant).

    All routes run the same ``simulation_step`` on the same inputs; results
    are identical (test_sweep.py asserts equality).
    """
    B = jax.tree_util.tree_leaves(batched_masks)[0].shape[0]
    if route == "auto":
        route = auto_route(params)
    if route not in ("vmap", "map"):
        raise ValueError(f"unknown sweep route: {route!r}")

    if route == "map":
        mp = params.replace(batched=True)

        def one_geometry(masks_g):
            def body(st, _):
                st, stats = simulation_step(st, masks_g, mp)
                return st, stats
            return jax.lax.scan(body, init_state(mp), None, length=steps)

        final, stats = jax.lax.map(one_geometry, batched_masks)
        # per-geometry (B, steps, ...) -> (steps, B, ...) to match vmap
        stats = jax.tree_util.tree_map(
            lambda x: jnp.swapaxes(x, 0, 1), stats)
        return final, stats

    # batched=True: the inlet formulation that keeps the routes bitwise
    # equal (models/windtunnel.py::_apply_inlets)
    params = params.replace(batched=True)

    state0 = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), init_state(params))

    step_v = jax.vmap(lambda s, m: simulation_step(s, m, params))

    def body(st, _):
        st, stats = step_v(st, batched_masks)
        return st, stats

    final, stats = jax.lax.scan(body, state0, None, length=steps)
    return final, stats


def drag_proxy(state: FluidState, params: SimParams) -> jnp.ndarray:
    """Cheap per-geometry objective for sweeps: mean momentum deficit at the
    outflow plane relative to the inlet speed."""
    vx_out = state.vx[1:-1, 1:-1, -2]
    return jnp.asarray(params.speed, vx_out.dtype) - jnp.mean(vx_out)
