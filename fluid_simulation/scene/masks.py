"""Precomputed boundary/obstacle masks.

The reference evaluates per-cell conditionals inside every hot loop:
``setBounds``'s solid-zeroing and staircase no-slip passes
(``simulation.cpp:218-245``) and ``project``'s obstacle-aware
divergence/gradient branches (``simulation.cpp:297-357``). Here all of them
are evaluated once per scene and become pure multiplies/selects in the
solver.

All masks live on device and travel with the state pytree, so the jitted step
never touches the host.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp


class SceneMasks(NamedTuple):
    """Pytree of precomputed masks. Shapes:

    - padded ``(D+2, H+2, W+2)``: ``solid``, ``keep_scalar``, ``keep_vel``
    - interior ``(D, H, W)``: ``fluid_i``, ``red_i`` and the six one-sided
      neighbor-validity masks ``nb_*`` used by projection.

    ``nb_xp[z,y,x]`` is 1 where the +x neighbor is both in-bounds
    (``i+1 <= width``) and fluid — exactly the guard in
    ``simulation.cpp:307-312`` / ``:329-355``. Note the padding shell never
    counts as a valid neighbor even though its ``obs`` is 0.
    """

    solid: jnp.ndarray        # padded, 1.0 = solid (obs contract, simulation.h:23)
    keep_scalar: jnp.ndarray  # padded, 0 inside solids, 1 elsewhere
    keep_vel: jnp.ndarray     # padded, 0 inside solids AND fluid cells 6-adjacent to a solid
    fluid_i: jnp.ndarray      # interior, 1.0 = fluid
    red_i: jnp.ndarray        # interior, 1.0 where (x+y+z) of 1-based coords is even
    nb_xp: jnp.ndarray
    nb_xm: jnp.ndarray
    nb_yp: jnp.ndarray
    nb_ym: jnp.ndarray
    nb_zp: jnp.ndarray
    nb_zm: jnp.ndarray

    @property
    def interior_shape(self):
        return self.fluid_i.shape


@functools.partial(jax.jit, static_argnames=("dtype",))
def build_masks(obstacles: jnp.ndarray, dtype=jnp.float32) -> SceneMasks:
    """Derive every solver mask from the padded obstacle field (1=solid).

    ``obstacles`` has padded shape ``(D+2, H+2, W+2)``; the ghost shell must be
    zero (the reference only ever writes interior cells via ``addObstacle``,
    ``simulation.cpp:155-158``).

    Jitted, so the masks are built in one program on the device.
    """
    obs = jnp.asarray(obstacles, dtype=jnp.float32)
    if obs.ndim != 3:
        raise ValueError(f"obstacles must be 3-D padded, got shape {obs.shape}")

    solid = (obs >= 0.5).astype(dtype)
    solid_i = solid[1:-1, 1:-1, 1:-1]
    fluid_i = 1.0 - solid_i

    # Fluid cell 6-adjacent to a solid (staircase no-slip, simulation.cpp:226-245).
    # Neighbors outside the interior have solid=0 in the ghost shell, which
    # reproduces the `i±1` bounds guards for free.
    adj = (
        solid[1:-1, 1:-1, 2:] + solid[1:-1, 1:-1, :-2]
        + solid[1:-1, 2:, 1:-1] + solid[1:-1, :-2, 1:-1]
        + solid[2:, 1:-1, 1:-1] + solid[:-2, 1:-1, 1:-1]
    )
    adj_fluid_i = jnp.where((adj > 0) & (solid_i < 0.5), 1.0, 0.0).astype(dtype)

    keep_scalar = jnp.ones_like(solid).at[1:-1, 1:-1, 1:-1].set(fluid_i)
    keep_vel = keep_scalar.at[1:-1, 1:-1, 1:-1].set(fluid_i * (1.0 - adj_fluid_i))

    D, H, W = solid_i.shape

    def _inbounds(axis_len, axis, sign):
        # 1 where the ±1 neighbor along `axis` stays inside the interior.
        coord = jnp.arange(1, axis_len + 1)
        ok = (coord + sign >= 1) & (coord + sign <= axis_len)
        shape = [1, 1, 1]
        shape[axis] = axis_len
        return ok.reshape(shape).astype(dtype)

    fluid_pad = 1.0 - solid  # padded fluid indicator (ghost shell = fluid)
    nb_xp = fluid_pad[1:-1, 1:-1, 2:] * _inbounds(W, 2, +1)
    nb_xm = fluid_pad[1:-1, 1:-1, :-2] * _inbounds(W, 2, -1)
    nb_yp = fluid_pad[1:-1, 2:, 1:-1] * _inbounds(H, 1, +1)
    nb_ym = fluid_pad[1:-1, :-2, 1:-1] * _inbounds(H, 1, -1)
    nb_zp = fluid_pad[2:, 1:-1, 1:-1] * _inbounds(D, 0, +1)
    nb_zm = fluid_pad[:-2, 1:-1, 1:-1] * _inbounds(D, 0, -1)

    # Red/black parity of the 1-based interior coordinates (x+y+z even = red).
    zi = jnp.arange(1, D + 1).reshape(D, 1, 1)
    yi = jnp.arange(1, H + 1).reshape(1, H, 1)
    xi = jnp.arange(1, W + 1).reshape(1, 1, W)
    red_i = (((zi + yi + xi) % 2) == 0).astype(dtype)

    return SceneMasks(
        solid=solid,
        keep_scalar=keep_scalar.astype(dtype),
        keep_vel=keep_vel.astype(dtype),
        fluid_i=fluid_i.astype(dtype),
        red_i=red_i,
        nb_xp=nb_xp, nb_xm=nb_xm,
        nb_yp=nb_yp, nb_ym=nb_ym,
        nb_zp=nb_zp, nb_zm=nb_zm,
    )
