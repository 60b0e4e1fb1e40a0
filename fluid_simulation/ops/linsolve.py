"""Linear solver (6-neighbor relaxation) and diffusion.

The reference runs ``acc`` in-place Gauss-Seidel sweeps with ``setBounds``
after every sweep (simulation.cpp:251-273). In-place GS under OpenMP is racy
and thread-count-dependent; a functional rebuild must pick a deterministic
ordering, so three are provided (SURVEY.md §7 "GS parity"):

- ``jacobi``:       f_new = (prev + a*sum6(f_old)) / c — fully parallel.
- ``rbgs``:         red-black Gauss-Seidel — same convergence class as
                    sequential GS, two fully-parallel half-sweeps.
- ``gs_wavefront``: hyperplane (i+j+k = const) ordering. For this stencil the
                    lexicographic sweep's already-updated neighbors are exactly
                    the smaller-sum ones, so wavefront ordering reproduces the
                    1-thread reference sweep *numerically identically* (used by
                    the golden parity tests; O(W+H+D) sequential stages).

The per-cell update keeps the reference's operand order
(simulation.cpp:263-269): ``(prev + a*((x+1)+(x-1)+(y+1)+(y-1)+(z+1)+(z-1)))
* (1/c)`` with the reciprocal precomputed, so f32 rounding matches.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from fluid_simulation.ops.bounds import set_bounds
from fluid_simulation.scene.masks import SceneMasks


def neighbor_sum(f: jnp.ndarray) -> jnp.ndarray:
    """Sum of the six face neighbors over the interior, in the reference's
    left-associated add order (simulation.cpp:266-268)."""
    return (
        (((f[1:-1, 1:-1, 2:] + f[1:-1, 1:-1, :-2])
          + f[1:-1, 2:, 1:-1]) + f[1:-1, :-2, 1:-1])
        + f[2:, 1:-1, 1:-1]
    ) + f[:-2, 1:-1, 1:-1]


def _update(f, prev_i, a, c_recip):
    return (prev_i + a * neighbor_sum(f)) * c_recip


def linear_solver(
    b: int,
    f: jnp.ndarray,
    prev: jnp.ndarray,
    a: float,
    c: float,
    masks: SceneMasks,
    acc: int = 15,
    solver: str = "rbgs",
    wall_mode: str = "reference",
    use_pallas: bool = False,
    empty_scene: bool = False,
) -> jnp.ndarray:
    """Run ``acc`` relaxation sweeps of ``f = (prev + a*sum6(f))/c`` with
    boundary conditions re-applied after each sweep (simulation.cpp:271).

    With ``use_pallas`` and solver='rbgs' on the GPU, each sweep is one
    launch of the fused kernel (kernels/rbgs_sweep.py, the same update as
    the jnp sweep below); elsewhere the jnp sweeps run."""
    if use_pallas and solver == "rbgs" and jax.default_backend() == "gpu":
        from fluid_simulation.kernels.rbgs_sweep import rbgs_sweep
        keep = None if empty_scene else (
            masks.keep_vel if b in (1, 2, 3) else masks.keep_scalar)

        def kernel_sweep(fc, _):
            return rbgs_sweep(b, fc, prev, keep, a, c, wall_mode), None

        return jax.lax.scan(kernel_sweep, f, None, length=acc)[0]
    dtype = f.dtype
    a = jnp.asarray(a, dtype)
    c_recip = jnp.asarray(np.float32(1.0) / np.float32(c), dtype)
    prev_i = prev[1:-1, 1:-1, 1:-1]

    if solver == "jacobi":
        def sweep(fc, _):
            upd = _update(fc, prev_i, a, c_recip)
            fc = fc.at[1:-1, 1:-1, 1:-1].set(upd)
            return set_bounds(b, fc, masks, wall_mode, empty_scene), None

    elif solver == "rbgs":
        red = masks.red_i.astype(bool)

        def sweep(fc, _):
            upd = _update(fc, prev_i, a, c_recip)
            fc = fc.at[1:-1, 1:-1, 1:-1].set(
                jnp.where(red, upd, fc[1:-1, 1:-1, 1:-1]))
            upd = _update(fc, prev_i, a, c_recip)
            fc = fc.at[1:-1, 1:-1, 1:-1].set(
                jnp.where(red, fc[1:-1, 1:-1, 1:-1], upd))
            return set_bounds(b, fc, masks, wall_mode, empty_scene), None

    elif solver == "gs_wavefront":
        D, H, W = masks.interior_shape
        zi = jnp.arange(1, D + 1).reshape(D, 1, 1)
        yi = jnp.arange(1, H + 1).reshape(1, H, 1)
        xi = jnp.arange(1, W + 1).reshape(1, 1, W)
        coord_sum = zi + yi + xi  # ranges 3 .. W+H+D

        def sweep(fc, _):
            def stage(s, fs):
                upd = _update(fs, prev_i, a, c_recip)
                return fs.at[1:-1, 1:-1, 1:-1].set(
                    jnp.where(coord_sum == s, upd, fs[1:-1, 1:-1, 1:-1]))
            fc = jax.lax.fori_loop(3, W + H + D + 1, stage, fc)
            return set_bounds(b, fc, masks, wall_mode, empty_scene), None

    else:
        raise ValueError(f"unknown solver {solver!r}")

    f, _ = jax.lax.scan(sweep, f, None, length=acc)
    return f


def diffusion_coeffs(width: int, height: int, depth: int, dt: float, diff: float):
    """``a = dt*diff*W*H*D`` and ``c = 1+6a`` in f32 with the reference's
    evaluation order (simulation.cpp:282-283). The N^3 scaling is the
    reference's generalization of Stam's demo constant — behavior, kept."""
    a = np.float32(dt) * np.float32(diff)
    a = a * np.float32(width) * np.float32(height) * np.float32(depth)
    c = np.float32(1.0) + np.float32(6.0) * a
    return float(a), float(c)


def diffuse(
    b: int,
    f: jnp.ndarray,
    prev: jnp.ndarray,
    masks: SceneMasks,
    dt: float,
    diff: float,
    acc: int = 15,
    solver: str = "rbgs",
    wall_mode: str = "reference",
    use_pallas: bool = False,
    empty_scene: bool = False,
) -> jnp.ndarray:
    """Diffusion wrapper (simulation.cpp:278-284). Like the reference, the
    caller chooses the coefficient — velocity compat mode passes ``diff``, not
    ``visc`` (``visc`` is never read there, simulation.h:63)."""
    D2, H2, W2 = f.shape
    a, c = diffusion_coeffs(W2 - 2, H2 - 2, D2 - 2, dt, diff)
    return linear_solver(b, f, prev, a, c, masks, acc=acc, solver=solver,
                         wall_mode=wall_mode, use_pallas=use_pallas,
                         empty_scene=empty_scene)
