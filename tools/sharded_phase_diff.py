#!/usr/bin/env python3
"""Where do the sharded step and the one-device step first differ?

Both steps are rebuilt here phase by phase from the same calls that
``models/windtunnel.py::simulation_step`` and
``parallel/sharded.py::_local_step`` make (inlets, the three diffusions,
projection, velocity advection, projection, density advection), each
truncated after one phase and compiled as its own program. Both start from
one common state: the one-device state after ``--steps`` steps of the bench's
sphere. For each phase it prints one JSON line with, per field, the number
of cells that differ and max |diff| / max |field|.

The sharded side runs on a 1-D z mesh of ``--devices`` devices: 4 virtual
CPU devices, e.g.

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tools/sharded_phase_diff.py --devices 4

or one GPU (``--devices 1``: the sharded program's arithmetic, no halos).
Only vorticity-free runs are rebuilt.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PHASES = ("inlets", "diffuse vx", "diffuse vy vz", "project 1",
          "advect velocity", "project 2", "advect density")


def one_device_phase(state, masks, p, k):
    """The one-device step (``simulation_step``) up to phase ``k``."""
    import jax.numpy as jnp
    from fluid_simulation.models import windtunnel as wtm
    from fluid_simulation.ops.advect import advect, advect_split_jnp
    from fluid_simulation.ops.linsolve import diffuse
    kw = dict(acc=p.acc, solver=p.solver, wall_mode=p.wall_mode,
              use_pallas=p.use_pallas, empty_scene=p.empty_scene)
    state, buffer = wtm._apply_inlets(state, p)
    vx, vy, vz, dens = state
    out = [(vx, vy, vz, dens)]
    pvx, pvy, pvz = vx, vy, vz
    vx = diffuse(1, vx, pvx, masks, p.dt, p.diff, **kw)
    out.append((vx, vy, vz, dens))
    vy = diffuse(2, vy, pvy, masks, p.dt, p.diff, **kw)
    vz = diffuse(3, vz, pvz, masks, p.dt, p.diff, **kw)
    out.append((vx, vy, vz, dens))
    vx, vy, vz = wtm._project(vx, vy, vz, masks, p)
    out.append((vx, vy, vz, dens))
    if p.mode == "split":
        smp = advect_split_jnp(jnp.stack([pvx, pvy, pvz]), vx, vy, vz, p.dt)
        vx, vy, vz = wtm._pad_bounds_tail(smp, (1, 2, 3), masks, p)
    else:
        args = (masks, p.dt, p.wall_mode, p.empty_scene)
        vx = advect(1, pvx, vx, vy, vz, *args)
        vy = advect(2, pvy, vx, vy, vz, *args)
        vz = advect(3, pvz, vx, vy, vz, *args)
    out.append((vx, vy, vz, dens))
    vx, vy, vz = wtm._project(vx, vy, vz, masks, p)
    out.append((vx, vy, vz, dens))
    if p.mode == "split":
        smp = advect_split_jnp(buffer, vx, vy, vz, p.dt)
        dens, = wtm._pad_bounds_tail(smp, (0,), masks, p)
    else:
        dens = advect(0, buffer, vx, vy, vz, masks, p.dt, p.wall_mode,
                      p.empty_scene)
    out.append((vx, vy, vz, dens))
    return out[k]


def sharded_phase(state, solid, p, k):
    """The sharded step (``_local_step``, 1-D mesh) up to phase ``k``; runs
    inside ``shard_map``."""
    import jax.numpy as jnp
    from jax import lax
    from fluid_simulation.ops.linsolve import diffusion_coeffs
    from fluid_simulation.parallel import sharded as sh
    n, i = lax.axis_size(sh.AXIS), lax.axis_index(sh.AXIS)
    Dl = state[0].shape[0] - 2
    lm = sh._local_masks(solid, n, i, p.depth, p.height, p.width, Dl,
                         Hl=p.height)
    vx, vy, vz, dens = state
    dens = dens.at[1:-1, 1:-1, 1].add(
        jnp.asarray(np.float32(p.inlet_density), dens.dtype))
    vx = vx.at[1:-1, 1:-1, 1].set(jnp.asarray(np.float32(p.speed), vx.dtype))
    vy = vy.at[1:-1, 1:-1, 1].set(0.0)
    vz = vz.at[1:-1, 1:-1, 1].set(0.0)
    vx, vy, vz, dens = [sh._exchange_interior(f, n, i)
                        for f in (vx, vy, vz, dens)]
    out = [(vx, vy, vz, dens)]
    buffer = dens
    pvx, pvy, pvz = vx, vy, vz
    a, c = diffusion_coeffs(p.width, p.height, p.depth, p.dt, p.diff)
    solve = (lambda b, f, prev: sh._solve(
        b, f, prev, a, c, lm, lm.keep_vel, p.acc, p.solver, p.wall_mode,
        n, i))
    vx = solve(1, vx, pvx)
    out.append((vx, vy, vz, dens))
    vy = solve(2, vy, pvy)
    vz = solve(3, vz, pvz)
    out.append((vx, vy, vz, dens))
    vx, vy, vz, _, _ = sh._project(vx, vy, vz, lm, p, n, i)
    out.append((vx, vy, vz, dens))
    if p.mode == "split":
        vx, vy, vz = [
            sh._set_bounds_ex(b, sh._advect_split_local(
                prev, vx, vy, vz, lm, lm.keep_vel, p, n, i),
                lm.keep_vel, p.wall_mode, n, i)
            for b, prev in ((1, pvx), (2, pvy), (3, pvz))]
    else:
        vx = sh._advect(1, pvx, vx, vy, vz, lm, lm.keep_vel, p, n, i)
        vy = sh._advect(2, pvy, vx, vy, vz, lm, lm.keep_vel, p, n, i)
        vz = sh._advect(3, pvz, vx, vy, vz, lm, lm.keep_vel, p, n, i)
    out.append((vx, vy, vz, dens))
    vx, vy, vz, _, _ = sh._project(vx, vy, vz, lm, p, n, i)
    out.append((vx, vy, vz, dens))
    if p.mode == "split":
        dens = sh._set_bounds_ex(0, sh._advect_split_local(
            buffer, vx, vy, vz, lm, lm.keep_scalar, p, n, i),
            lm.keep_scalar, p.wall_mode, n, i)
    else:
        dens = sh._advect(0, buffer, vx, vy, vz, lm, lm.keep_scalar, p, n, i)
    out.append((vx, vy, vz, dens))
    return out[k]


def phase_diffs(W, H, D, mode="split", steps=5, devices=4, sphere=True):
    """One record per phase: cells that differ and max |diff| / max |field|
    for vx, vy, vz and dens, sharded step vs one-device step."""
    import jax
    from jax.sharding import PartitionSpec as P
    from fluid_simulation import SimParams, WindTunnel
    from fluid_simulation.parallel import sharded as sh
    from fluid_simulation.scene.primitives import add_sphere, empty_obstacles
    obs = empty_obstacles(W, H, D)
    if sphere:
        obs = add_sphere(obs, cx=min(48, W // 3), cy=H // 2, cz=D // 2,
                         radius=min(40, H // 4))
    wt = WindTunnel(SimParams(width=W, height=H, depth=D, mode=mode),
                    obstacles=obs)
    if wt.params.vorticity:
        raise ValueError("vorticity confinement is not rebuilt here")
    if steps:
        wt.simulate(steps=steps)
    p, state0 = wt.params, wt.state
    sw = sh.ShardedWindTunnel(p, obstacles=obs, n_devices=devices)
    stacked = sh.FluidState(*[sw._shard(sw._split(np.asarray(f)))
                              for f in state0])
    recs = []
    for k, name in enumerate(PHASES):
        ref = jax.jit(lambda s, m, k=k: one_device_phase(s, m, p, k))(
            state0, wt.masks)

        def body(st, solid, k=k):
            st = jax.tree_util.tree_map(lambda x: x[0], st)
            return tuple(x[None] for x in sharded_phase(st, solid[0], p, k))
        got = jax.jit(jax.shard_map(
            body, mesh=sw.mesh, in_specs=(P(sh.AXIS), P(sh.AXIS)),
            out_specs=P(sh.AXIS), check_vma=False))(stacked, sw.solid_stacked)
        rec = {"phase": name, "mode": mode, "grid": f"{W}x{H}x{D}",
               "devices": devices, "steps_before": steps}
        for field, r, g in zip(("vx", "vy", "vz", "dens"), ref, got):
            r = np.asarray(r)
            g = sh.stitch_padded(np.asarray(g))
            rec[field] = {"n_diff": int((r != g).sum()),
                          "rel_max_diff": float(np.abs(r - g).max()
                                                / (np.abs(r).max() + 1e-30))}
        recs.append(rec)
    return recs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--grid", default="128x64x64")
    ap.add_argument("--modes", default="split,compat")
    ap.add_argument("--steps", type=int, default=5,
                    help="one-device steps that make the common input")
    ap.add_argument("--devices", type=int, default=4)
    args = ap.parse_args()
    W, H, D = (int(v) for v in args.grid.split("x"))
    import jax
    d = jax.devices()[0]
    print(json.dumps({"device": {"platform": d.platform,
                                 "kind": d.device_kind,
                                 "count": len(jax.devices())}}), flush=True)
    for mode in args.modes.split(","):
        for rec in phase_diffs(W, H, D, mode, args.steps, args.devices):
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
