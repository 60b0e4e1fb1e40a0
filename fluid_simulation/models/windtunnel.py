"""The wind-tunnel model: the reference's whole program as one jitted step.

Time-step composition mirrors ``Simulation::run`` + ``Simulation::step``
(simulation.cpp:49-150):

  per step (run loop, :63-71):  inlet density += 0.001 on the x=1 plane;
                                buffer = dens;            then step():
  step (:96-150):               inlet velocity (speed,0,0) on the x=1 plane;
                                v_prev = v  (pre-diffusion save, :107-110);
                                diffuse vx,vy,vz; project;
                                advect vx,vy,vz from v_prev (order-dependent
                                chain, :125-127); project again;
                                density diffuse + advect from buffer.

Two deliberate deviations, both output-preserving or opt-in:

- the density diffusion's result is provably dead in the reference — advection
  rewrites every cell from the *pre*-diffusion ``buffer``
  (simulation.cpp:135-136 with :371-421) — so it is not computed; outputs are
  identical and XLA would DCE it anyway.
- the default ``'compat'`` keeps the reference's sequential advection chain;
  ``mode='fast'`` switches to *simultaneous* trilinear advection (one shared
  backtrace through the post-projection field, the standard stable-fluids
  formulation); ``mode='split'`` uses operator-split advection: three 1-D
  lerp passes per field (ops/advect.py::advect_split_jnp).

The whole time loop runs under ``jax.lax.scan`` — zero host round-trips; the
reference's per-step 11.3 MB file write (simulation.cpp:140-148) becomes
either on-device frame stacking or an async host writer (io/dump.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from fluid_simulation.config import SimParams
from fluid_simulation.ops.advect import (
    advect, advect_split_jnp, backtrace, trilinear_gather)
from fluid_simulation.ops.bounds import face_signs
from fluid_simulation.ops.linsolve import diffuse
from fluid_simulation.ops.project import project, divergence, grid_h
from fluid_simulation.ops.vorticity import apply_confinement
from fluid_simulation.scene.masks import SceneMasks, build_masks


class FluidState(NamedTuple):
    """Padded (D+2, H+2, W+2) field pytree — the analog of the reference's
    member arrays (simulation.h:16-27). Pressure/divergence are recomputed
    per projection and surfaced via StepStats instead of being carried."""

    vx: jnp.ndarray
    vy: jnp.ndarray
    vz: jnp.ndarray
    dens: jnp.ndarray


class StepStats(NamedTuple):
    """Per-step scalars (the reference prints density sums every 100 steps,
    simulation.cpp:73-77; we keep them every step for free inside scan)."""

    density_sum: jnp.ndarray
    max_divergence: jnp.ndarray


def _dtype(params: SimParams):
    return jnp.bfloat16 if params.dtype == "bfloat16" else jnp.float32


@functools.partial(jax.jit, static_argnames=("params",))
def init_state(params: SimParams) -> FluidState:
    """All-zero fields, like the ctor fill (simulation.cpp:38-43). Jitted so
    the arrays are cheap to read back (see build_masks on eager readback)."""
    shape = params.padded_shape
    dt = _dtype(params)
    z = jnp.zeros(shape, dt)
    return FluidState(vx=z, vy=z, vz=z, dens=z)


def _apply_inlets(state: FluidState, params: SimParams) -> Tuple[FluidState, jnp.ndarray]:
    """Inlet density (run loop, simulation.cpp:64-67) and inlet velocity
    (step, simulation.cpp:102-105) on the x=1 interior plane; returns the
    post-inlet density copy (``buffer = dens``, simulation.cpp:70).

    Written as iota-masked ``where`` selects rather than ``.at[...].set``:
    a plane ``.at[].set`` can lower to a full-array dynamic-update-slice,
    while the selects fuse into the neighbouring elementwise pass. Values
    are bitwise identical per call: ``where(m, x + c, x)`` /
    ``where(m, c, x)`` write the exact same words as the indexed update
    (f32 + bf16, plain and vmapped, checked on CPU).

    ``params.batched`` keeps the indexed updates: inside the VMAPPED sweep
    step the select formulation perturbs downstream XLA fusion enough to
    flip f32 contractions (~1e-5 after 3 steps on CPU), breaking the
    bitwise route-equality contract (test_sweep_routes_agree)."""
    if params.batched:
        dens = state.dens.at[1:-1, 1:-1, 1].add(
            jnp.asarray(np.float32(params.inlet_density), state.dens.dtype))
        vx = state.vx.at[1:-1, 1:-1, 1].set(
            jnp.asarray(np.float32(params.speed), state.vx.dtype))
        vy = state.vy.at[1:-1, 1:-1, 1].set(0.0)
        vz = state.vz.at[1:-1, 1:-1, 1].set(0.0)
        return FluidState(vx, vy, vz, dens), dens
    shape = state.dens.shape
    zi = lax.broadcasted_iota(jnp.int32, shape, 0)
    yi = lax.broadcasted_iota(jnp.int32, shape, 1)
    xi = lax.broadcasted_iota(jnp.int32, shape, 2)
    m = ((xi == 1) & (zi >= 1) & (zi <= shape[0] - 2)
         & (yi >= 1) & (yi <= shape[1] - 2))
    dt = state.dens.dtype
    dens = jnp.where(
        m, state.dens + jnp.asarray(np.float32(params.inlet_density), dt),
        state.dens)
    vx = jnp.where(m, jnp.asarray(np.float32(params.speed), dt), state.vx)
    vy = jnp.where(m, jnp.asarray(0.0, dt), state.vy)
    vz = jnp.where(m, jnp.asarray(0.0, dt), state.vz)
    return FluidState(vx, vy, vz, dens), dens


def _pad_bounds_tail(smp, bs, masks, p: SimParams):
    """Rebuild padded fields + setBounds from advected interior samples.
    ``smp`` is (len(bs), D, H, W) or (D, H, W).

    Each padded field is built as nested concats — one fused pass per field
    — instead of the zeros.at[].set + set_bounds chain (XLA materialises a
    full-array copy per face write there). Identical values: interior
    iv*keep, faces are signed mirrors of the pre-keep edge, ghost
    edges/corners zero."""
    if smp.ndim == 3:
        smp = smp[None]
    dt = smp.dtype
    keep_i = None
    if not p.empty_scene:
        keep = masks.keep_vel if bs[0] in (1, 2, 3) else masks.keep_scalar
        keep_i = keep[1:-1, 1:-1, 1:-1].astype(dt)
    outs = []
    for i, b in enumerate(bs):
        iv = smp[i] if p.empty_scene else smp[i] * masks.fluid_i.astype(dt)
        core = iv if keep_i is None else iv * keep_i
        sx, sy, sz = (jnp.asarray(s, dt) for s in face_signs(b, p.wall_mode))
        lvl1 = jnp.concatenate(
            [sx * iv[:, :, :1], core, iv[:, :, -1:]], axis=2)
        zc = jnp.zeros((iv.shape[0], 1, 1), dt)
        fy0 = jnp.concatenate([zc, sy * iv[:, :1, :], zc], axis=2)
        fy1 = jnp.concatenate([zc, sy * iv[:, -1:, :], zc], axis=2)
        lvl2 = jnp.concatenate([fy0, lvl1, fy1], axis=1)
        fz0 = jnp.pad(sz * iv[:1], ((0, 0), (1, 1), (1, 1)))
        fz1 = jnp.pad(sz * iv[-1:], ((0, 0), (1, 1), (1, 1)))
        outs.append(jnp.concatenate([fz0, lvl2, fz1], axis=0))
    return tuple(outs)


def _project(vx, vy, vz, masks, p: SimParams):
    out = project(vx, vy, vz, masks, acc=p.acc, solver=p.solver,
                  wall_mode=p.wall_mode, use_pallas=p.use_pallas,
                  empty_scene=p.empty_scene)
    return out[0], out[1], out[2]


@functools.partial(jax.jit, static_argnames=("params",))
def simulation_step(state: FluidState, masks: SceneMasks,
                    params: SimParams) -> Tuple[FluidState, StepStats]:
    """Advance one full time step. Pure; jitted with ``params`` static."""
    p = params
    kw = dict(acc=p.acc, solver=p.solver, wall_mode=p.wall_mode,
              use_pallas=p.use_pallas, empty_scene=p.empty_scene)

    state, buffer = _apply_inlets(state, p)
    vx, vy, vz, dens = state
    pvx, pvy, pvz = vx, vy, vz   # pre-diffusion save (simulation.cpp:107-110)

    vel_diff = p.visc if p.use_visc_for_velocity else p.diff  # compat: diff
    vx = diffuse(1, vx, pvx, masks, p.dt, vel_diff, **kw)
    vy = diffuse(2, vy, pvy, masks, p.dt, vel_diff, **kw)
    vz = diffuse(3, vz, pvz, masks, p.dt, vel_diff, **kw)
    vx, vy, vz = _project(vx, vy, vz, masks, p)

    if p.mode == "compat":
        # Sequential component advection (simulation.cpp:125-127): each later
        # component backtraces through already-advected earlier components.
        vx2 = advect(1, pvx, vx, vy, vz, masks, p.dt, p.wall_mode,
                     p.empty_scene)
        vy2 = advect(2, pvy, vx2, vy, vz, masks, p.dt, p.wall_mode,
                     p.empty_scene)
        vz2 = advect(3, pvz, vx2, vy2, vz, masks, p.dt, p.wall_mode,
                     p.empty_scene)
        vx, vy, vz = vx2, vy2, vz2
    elif p.mode == "fast":
        # Simultaneous advection: one shared backtrace through the projected
        # field, three gathers. Standard formulation; not bit-compatible.
        D, H, W = p.depth, p.height, p.width
        xb, yb, zb = backtrace(
            vx[1:-1, 1:-1, 1:-1], vy[1:-1, 1:-1, 1:-1], vz[1:-1, 1:-1, 1:-1],
            p.dt, W, H, D, vx.dtype)
        smp = jnp.stack([trilinear_gather(prev, xb, yb, zb)
                         for prev in (pvx, pvy, pvz)])
        vx, vy, vz = _pad_bounds_tail(smp, (1, 2, 3), masks, p)
    elif p.mode == "split":
        # Operator-split advection: three 1-D lerp passes; standard
        # production formulation, not bit-compatible with the trilinear
        # backtrace. The three components share one stacked pass.
        smp = advect_split_jnp(jnp.stack([pvx, pvy, pvz]), vx, vy, vz, p.dt)
        vx, vy, vz = _pad_bounds_tail(smp, (1, 2, 3), masks, p)
    else:
        raise ValueError(f"unknown mode {p.mode!r}")

    if p.vorticity:
        vx, vy, vz = apply_confinement(vx, vy, vz, masks, p.vorticity, p.dt)

    vx, vy, vz = _project(vx, vy, vz, masks, p)

    # Density transport. The reference's diffuse(0, dens, buffer) result is
    # fully overwritten by this advection (see module docstring) — skipped.
    if p.mode == "split":
        smp = advect_split_jnp(buffer, vx, vy, vz, p.dt)
        dens, = _pad_bounds_tail(smp, (0,), masks, p)
    else:
        dens = advect(0, buffer, vx, vy, vz, masks, p.dt, p.wall_mode,
                      p.empty_scene)

    new_state = FluidState(vx, vy, vz, dens)
    if p.div_stats:
        h = grid_h(p.width, p.height, p.depth)
        max_div = jnp.max(jnp.abs(divergence(vx, vy, vz, masks, h)))
    else:
        max_div = jnp.asarray(jnp.nan, jnp.float32)
    if p.step_stats:
        density_sum = jnp.sum(dens, dtype=jnp.float32)
    else:
        # the reference only sums density every 100 steps
        density_sum = jnp.asarray(jnp.nan, jnp.float32)
    stats = StepStats(density_sum=density_sum, max_divergence=max_div)
    return new_state, stats


@functools.partial(jax.jit, static_argnames=("params", "steps", "record"))
def simulate(state: FluidState, masks: SceneMasks, params: SimParams,
             steps: int, record: bool = False):
    """Run ``steps`` under ``lax.scan``. With ``record=True`` the per-step
    fields are stacked on device (the dump-file analog of the reference's
    per-step write, simulation.cpp:143-147); otherwise only stats stream out.
    """

    def body(st, _):
        st, stats = simulation_step(st, masks, params)
        out = (stats, st) if record else stats
        return st, out

    final, ys = jax.lax.scan(body, state, None, length=steps)
    return final, ys


class WindTunnel:
    """Convenience wrapper tying params + scene masks + jitted step together —
    the ergonomic equivalent of constructing ``Simulation`` and calling
    ``run()`` (simulation.cpp:429-451), minus the hardcoding."""

    def __init__(self, params: SimParams = SimParams(),
                 obstacles: Optional[np.ndarray] = None):
        self.params = params
        if obstacles is None:
            obstacles = np.zeros(params.padded_shape, np.float32)
        if tuple(obstacles.shape) != params.padded_shape:
            raise ValueError(
                f"obstacle shape {obstacles.shape} != padded {params.padded_shape}")
        # kept as host numpy: the cell-edit API below edits it in place, and
        # jit inputs are transferred host->device on call.
        self.obstacles = np.asarray(obstacles, np.float32)
        # empty scenes statically skip obstacle-mask arithmetic (exact
        # identity); always derived from the actual obstacle field here.
        # An explicit empty_scene=True together with solids is a user error
        # that would silently produce wrong physics if it reached
        # simulation_step directly — reject it (config.py:79-84 contract).
        has_solids = bool((self.obstacles >= 0.5).any())
        if params.empty_scene and has_solids:
            raise ValueError(
                "SimParams(empty_scene=True) with a non-empty obstacle "
                "field: empty_scene statically skips all obstacle masking "
                "and must only be set for scenes without solids")
        self.params = params = params.replace(empty_scene=not has_solids)
        self.masks = build_masks(self.obstacles, dtype=_dtype(params))
        self.state = init_state(params)

    def reset(self):
        self.state = init_state(self.params)
        return self.state

    def step(self) -> StepStats:
        self.state, stats = simulation_step(self.state, self.masks, self.params)
        return stats

    def simulate(self, steps: int, record: bool = False):
        self.state, ys = simulate(self.state, self.masks, self.params,
                                  steps=steps, record=record)
        return self.state, ys

    # -- single-cell edit API (simulation.cpp:155-178) --------------------
    # Setup-time helpers; edits land in host NumPy copies (cheap, and jit
    # re-uploads on the next step — never create eager device arrays here).

    def add_obstacle(self, x: int, y: int, z: int):
        """Mark one interior cell solid (Simulation::addObstacle) and refresh
        the derived masks."""
        self._check_cell(x, y, z)
        self.obstacles[z, y, x] = 1.0
        self.masks = build_masks(self.obstacles, dtype=_dtype(self.params))
        self.params = self.params.replace(empty_scene=False)

    def add_density(self, x: int, y: int, z: int, amount: float):
        """Add density to one cell (Simulation::addDensity)."""
        self._check_cell(x, y, z)
        dens = np.array(self.state.dens)
        dens[z, y, x] += np.float32(amount)
        self.state = self.state._replace(dens=dens)

    def set_velocity(self, x: int, y: int, z: int,
                     vx: float, vy: float, vz: float):
        """Set the velocity of one cell (Simulation::setVelocity)."""
        self._check_cell(x, y, z)
        new = {k: np.array(v) for k, v in
               zip(("vx", "vy", "vz"), (self.state.vx, self.state.vy,
                                        self.state.vz))}
        for key, val in zip(("vx", "vy", "vz"), (vx, vy, vz)):
            new[key][z, y, x] = np.float32(val)
        self.state = self.state._replace(**new)

    def _check_cell(self, x, y, z):
        p = self.params
        if not (1 <= x <= p.width and 1 <= y <= p.height
                and 1 <= z <= p.depth):
            raise ValueError(
                f"cell ({x},{y},{z}) outside interior "
                f"1..{p.width} x 1..{p.height} x 1..{p.depth}")

    def density_sum(self) -> float:
        return float(_density_sum(self.state))

    def field_ranges(self):
        """Final min/max statistics, like simulation.cpp:81-90."""
        r = jax.device_get(_ranges(self.state))
        return {
            "density": (float(r[0]), float(r[1])),
            "vx": (float(r[2]), float(r[3])),
            "vy": (float(r[4]), float(r[5])),
            "vz": (float(r[6]), float(r[7])),
        }


@jax.jit
def _density_sum(state: FluidState):
    return jnp.sum(state.dens, dtype=jnp.float32)


@jax.jit
def _ranges(state: FluidState):
    s = state
    return jnp.stack([
        s.dens.min(), s.dens.max(), s.vx.min(), s.vx.max(),
        s.vy.min(), s.vy.max(), s.vz.min(), s.vz.max()]).astype(jnp.float32)


@jax.jit
def residual_stats(state: FluidState):
    """(max, mean) of |div v| in grid units over the interior — central
    differences, no obstacle masks. The reference's final frame measures
    9.29 / 0.258 (BASELINE.md); bench.py and chip_smoke.py bound it."""
    vx, vy, vz = (state.vx.astype(jnp.float32), state.vy.astype(jnp.float32),
                  state.vz.astype(jnp.float32))
    div = 0.5 * (
        vx[1:-1, 1:-1, 2:] - vx[1:-1, 1:-1, :-2]
        + vy[1:-1, 2:, 1:-1] - vy[1:-1, :-2, 1:-1]
        + vz[2:, 1:-1, 1:-1] - vz[:-2, 1:-1, 1:-1])
    a = jnp.abs(div)
    return jnp.max(a), jnp.mean(a, dtype=jnp.float32)
