#!/usr/bin/env python3
"""Measure the fused red-black sweep kernel against the jnp sweep on the GPU.

Phases (each prints its lines as it finishes):

  hlo     kernels XLA emits for one jnp sweep (fusions and other launches in
          the optimised HLO's entry computation), per grid;
  check   one 15-sweep solve, kernel vs jnp, max |diff| / max |f|;
  sweep   us per sweep of each kernel launch shape (``--configs``) and of
          the jnp sweep, in a scanned 15-sweep solve;
  step    ms per full jitted step, kernel (each of ``--step-configs``) vs
          jnp, timed in that order and then in reverse: 128x64x64 split
          empty and 512x256x256 split with the bench's sphere;
  routes  ms per batched step of the design-sweep routes (``--routes``) at
          B=8, split, on each of ``--route-grids``.

Run on the GPU from the repo root, e.g. ``python tools/kernel_ab.py
--phases hlo,check,sweep``. Each measurement is one JSON line on stdout, and
is appended to ``--out`` when given. Without a GPU it exits 1, unless
``--interpret`` is given: then the kernel runs in Pallas interpret mode and
only the untimed phases (hlo, check) may run, as a rehearsal of the script.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

GRIDS = {"128x64x64": (128, 64, 64), "256x128x128": (256, 128, 128),
         "512x256x256": (512, 256, 256),
         "24x12x10": (24, 12, 10)}   # the last for CPU rehearsals
# (label, (W, H, D), with the bench's sphere, scanned steps per call)
STEP_CELLS = (("128x64x64 split empty", (128, 64, 64), False, 50),
              ("512x256x256 split sphere", (512, 256, 256), True, 5))
ROUTE_STEPS = 10
UNTIMED = ("hlo", "check")
CONFIGS = ("2x256w4s1,1x512w4s1,4x128w4s1,2x512w8s1,4x256w8s1,1x1024w8s1,"
           "2x256w4s2,8x128w4s1")


def parse_config(s):
    blk, rest = s.split("w")
    bz, bp = (int(v) for v in blk.split("x"))
    warps, stages = (int(v) for v in rest.split("s"))
    return (bz, bp), warps, stages


def emit(out, rec):
    line = json.dumps(rec)
    print(line, flush=True)
    if out is not None:
        out.write(line + "\n")
        out.flush()


def timed(fn, *args, reps=5):
    """Median seconds of ``fn(*args)`` after one warm-up call."""
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def sphere(W, H, D):
    from fluid_simulation.scene.primitives import add_sphere, empty_obstacles
    if W == 128:
        return add_sphere(empty_obstacles(W, H, D), cx=40, cy=32, cz=32,
                          radius=10)
    return add_sphere(empty_obstacles(W, H, D), cx=48, cy=H // 2, cz=D // 2,
                      radius=40)


def solve_inputs(W, H, D, dtype, masked):
    import jax
    import jax.numpy as jnp
    from fluid_simulation.scene.masks import build_masks
    from fluid_simulation.scene.primitives import empty_obstacles
    obs = sphere(W, H, D) if masked else empty_obstacles(W, H, D)
    masks = build_masks(np.asarray(obs, np.float32), dtype=dtype)
    kf, kp = jax.random.split(jax.random.PRNGKey(0))
    shape = (D + 2, H + 2, W + 2)
    f = jax.jit(lambda k: jax.random.normal(k, shape, dtype))(kf)
    prev = jax.jit(lambda k: jax.random.normal(k, shape, dtype))(kp)
    return f, prev, masks


def phase_hlo(out, args):
    import jax
    import jax.numpy as jnp
    from fluid_simulation.ops.linsolve import diffusion_coeffs, linear_solver
    skip = {"parameter", "get-tuple-element", "tuple", "constant", "bitcast"}
    for name, (W, H, D) in args.grids:
        f, prev, masks = solve_inputs(W, H, D, jnp.float32, True)
        a, c = diffusion_coeffs(W, H, D, 0.05, 2e-5)
        fn = jax.jit(lambda f, p, m: linear_solver(
            1, f, p, a, c, m, acc=1, use_pallas=False))
        txt = fn.lower(f, prev, masks).compile().as_text()
        entry = txt[txt.index("ENTRY"):]
        entry = entry[:entry.index("\n}")]
        ops = []
        for line in entry.splitlines()[1:]:
            if "=" not in line:
                continue
            rhs = line.split("=", 1)[1].strip()
            op = rhs.split("(")[0].split()[-1]
            if op not in skip:
                ops.append(op)
        emit(out, {"phase": "hlo", "grid": name, "masked": True,
                   "fusions": ops.count("fusion"), "launches": len(ops),
                   "ops": ops})


def solve_fns(b, a, c, masked, wall="reference", block=None, warps=None,
              stages=None, acc=15, interpret=False):
    import jax
    from fluid_simulation.kernels.rbgs_sweep import rbgs_sweep
    from fluid_simulation.ops.linsolve import linear_solver

    def kern(f, prev, masks):
        keep = None if not masked else (
            masks.keep_vel if b else masks.keep_scalar)

        def body(fc, _):
            return rbgs_sweep(b, fc, prev, keep, a, c, wall, block=block,
                              num_warps=warps, num_stages=stages,
                              interpret=interpret), None
        return jax.lax.scan(body, f, None, length=acc)[0]

    def ref(f, prev, masks):
        return linear_solver(b, f, prev, a, c, masks, acc=acc,
                             wall_mode=wall, use_pallas=False,
                             empty_scene=not masked)
    return jax.jit(kern), jax.jit(ref)


def phase_check(out, args):
    import jax
    import jax.numpy as jnp
    from fluid_simulation.ops.linsolve import diffusion_coeffs
    rel = jax.jit(lambda x, y: jnp.max(jnp.abs(x.astype(jnp.float32)
                                               - y.astype(jnp.float32)))
                  / jnp.max(jnp.abs(y.astype(jnp.float32))))
    for name, (W, H, D) in args.grids:
        a, c = diffusion_coeffs(W, H, D, 0.05, 2e-5)
        for dtype in (jnp.float32, jnp.bfloat16):
            for masked in (False, True):
                f, prev, masks = solve_inputs(W, H, D, dtype, masked)
                for b, wall in ((0, "reference"), (1, "reference"),
                                (3, "noslip")):
                    aa, cc = (1.0, 6.0) if b == 0 else (a, c)
                    kern, ref = solve_fns(b, aa, cc, masked, wall,
                                          interpret=args.interpret)
                    t0 = time.perf_counter()
                    r = float(rel(kern(f, prev, masks), ref(f, prev, masks)))
                    rec = {"phase": "check", "grid": name,
                           "dtype": jnp.dtype(dtype).name, "masked": masked,
                           "b": b, "wall": wall, "rel_max_diff": r}
                    if not args.interpret:
                        rec["s_with_compile"] = time.perf_counter() - t0
                    emit(out, rec)


def phase_sweep(out, args):
    import jax.numpy as jnp
    from fluid_simulation.ops.linsolve import diffusion_coeffs
    for name, (W, H, D) in args.grids:
        a, c = diffusion_coeffs(W, H, D, 0.05, 2e-5)
        # enough sweeps per call that dispatch overhead is noise
        acc = 150 if W * H * D < 10 ** 6 else 30
        for masked in (False, True):
            f, prev, masks = solve_inputs(W, H, D, jnp.float32, masked)
            _, ref = solve_fns(1, a, c, masked, acc=acc)
            t = timed(ref, f, prev, masks)
            emit(out, {"phase": "sweep", "grid": name, "masked": masked,
                       "impl": "jnp", "us_per_sweep": t / acc * 1e6})
            for cfg in args.configs.split(","):
                block, warps, stages = parse_config(cfg)
                kern, _ = solve_fns(1, a, c, masked, block=block,
                                    warps=warps, stages=stages, acc=acc)
                try:
                    t = timed(kern, f, prev, masks)
                    emit(out, {"phase": "sweep", "grid": name,
                               "masked": masked, "impl": cfg,
                               "us_per_sweep": t / acc * 1e6})
                except Exception as e:  # a launch shape the card refuses
                    emit(out, {"phase": "sweep", "grid": name,
                               "masked": masked, "impl": cfg,
                               "error": f"{type(e).__name__}: {e}"[:300]})


def scanned_steps(params, n):
    import jax
    from fluid_simulation.models.windtunnel import simulation_step

    @jax.jit
    def run(state, m):
        def body(st, _):
            return simulation_step(st, m, params)[0], None
        return jax.lax.scan(body, state, None, length=n)[0]
    return run


def phase_step(out, args):
    import jax
    from fluid_simulation.config import SimParams
    from fluid_simulation.kernels import rbgs_sweep as rs
    from fluid_simulation.models.windtunnel import WindTunnel
    from fluid_simulation.scene.primitives import empty_obstacles
    default = rs.BLOCK, rs.NUM_WARPS, rs.NUM_STAGES
    for label, (W, H, D), masked, n in STEP_CELLS:
        obs = sphere(W, H, D) if masked else empty_obstacles(W, H, D)
        impls = args.step_configs.split(",") + ["jnp"]
        runs = {}
        for impl in impls:
            p = SimParams(width=W, height=H, depth=D, mode="split",
                          div_stats=False, step_stats=False,
                          use_pallas=impl != "jnp")
            if impl != "jnp":   # the launch shape is read while tracing
                rs.BLOCK, rs.NUM_WARPS, rs.NUM_STAGES = parse_config(impl)
            wt = WindTunnel(p, obstacles=obs)
            run = scanned_steps(wt.params, n)
            t0 = time.perf_counter()
            jax.block_until_ready(run(wt.state, wt.masks))
            runs[impl] = (run, wt, time.perf_counter() - t0)
        times = {impl: [] for impl in impls}
        for impl in impls + impls[::-1]:
            run, wt, _ = runs[impl]
            times[impl].append(
                timed(run, wt.state, wt.masks, reps=3) / n * 1e3)
        for impl in impls:
            emit(out, {"phase": "step", "cell": label, "impl": impl,
                       "ms_per_step": times[impl],
                       "s_first_call": runs[impl][2]})
        rs.BLOCK, rs.NUM_WARPS, rs.NUM_STAGES = default


def route_geometries(W, H, D):
    """The bench's sphere and seven spheres and boxes, placed as at
    128x64x64 and scaled with the grid."""
    from fluid_simulation.scene.primitives import (
        add_box, add_sphere, empty_obstacles)
    k_ = W // 128
    e = empty_obstacles(W, H, D)
    geoms = [np.asarray(add_sphere(e, 40 * k_, 32 * k_, 32 * k_, 10 * k_))]
    for k in range(7):
        g = (add_sphere(e, (30 + 6 * k) * k_, (20 + 3 * k) * k_, 28 * k_,
                        (5 + k % 3) * k_) if k % 2 else
             add_box(e, (20 + 5 * k) * k_, (35 + 5 * k) * k_, 20 * k_,
                     40 * k_, 24 * k_, 40 * k_))
        geoms.append(np.asarray(g))
    return geoms


def phase_routes(out, args):
    import jax
    import jax.numpy as jnp
    from fluid_simulation.config import SimParams
    from fluid_simulation.models.sweep import batch_masks, design_sweep
    n = ROUTE_STEPS
    for name in args.route_grids.split(","):
        W, H, D = GRIDS[name]
        bm = jax.tree_util.tree_map(jnp.asarray,
                                    batch_masks(route_geometries(W, H, D)))
        p = SimParams(width=W, height=H, depth=D, mode="split",
                      div_stats=False, step_stats=False)
        for route in args.routes.split(","):
            t0 = time.perf_counter()
            jax.block_until_ready(design_sweep(bm, p, steps=n, route=route))
            first = time.perf_counter() - t0
            t = timed(lambda m: design_sweep(m, p, steps=n, route=route), bm,
                      reps=3)
            emit(out, {"phase": "routes", "grid": name, "route": route,
                       "B": 8, "ms_per_batched_step": t / n * 1e3,
                       "geometry_steps_per_s": 8 * n / t,
                       "s_first_call": first})
        del bm


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="hlo,check,sweep,step,routes")
    ap.add_argument("--grids", default="128x64x64,512x256x256")
    ap.add_argument("--configs", default=CONFIGS,
                    help="kernel launch shapes, BZxBPwWARPSsSTAGES")
    ap.add_argument("--step-configs", default="4x128w4s1,2x256w4s1",
                    help="launch shapes the step phase times")
    ap.add_argument("--routes", default="vmap,map")
    ap.add_argument("--route-grids", default="128x64x64",
                    help="grids the routes phase times")
    ap.add_argument("--out", help="also append the JSON lines to this file")
    ap.add_argument("--interpret", action="store_true",
                    help="rehearse without a GPU: kernel in interpret mode, "
                         "untimed phases only")
    args = ap.parse_args()
    args.grids = [(g, GRIDS[g]) for g in args.grids.split(",")]
    phases = args.phases.split(",")
    if args.interpret and not set(phases) <= set(UNTIMED):
        ap.error(f"--interpret runs only the untimed phases {UNTIMED}")

    from fluid_simulation.utils.cache import enable_compile_cache
    enable_compile_cache()
    import jax
    d = jax.devices()[0]
    if d.platform != "gpu" and not args.interpret:
        print(f"kernel_ab: JAX found no GPU (platform {d.platform!r}); "
              "--interpret rehearses the untimed phases", file=sys.stderr)
        return 1
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    except FileNotFoundError:
        smi = "no nvidia-smi"
    with (open(args.out, "a") if args.out else contextlib.nullcontext()
          ) as out:
        emit(out, {"phase": "device", "platform": d.platform,
                   "kind": d.device_kind, "count": len(jax.devices()),
                   "nvidia_smi": smi})
        for ph in phases:
            t0 = time.perf_counter()
            globals()[f"phase_{ph}"](out, args)
            if not args.interpret:
                emit(out, {"phase": ph, "done_s": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
