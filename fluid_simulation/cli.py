"""Command-line driver.

The reference has no CLI — ``main()`` hardcodes the grid, step count, inlet
speed, and an absolute STL path on the author's machine
(simulation.cpp:429-451). Every one of those is a flag here.

Subcommands:
  run          simulate and optionally dump frames / checkpoints
  resume       continue a run from the latest checkpoint
  export-pngs  render PNG sequences from a dump (make_pngs.py, fixed for 3-D)
  view         open the slice viewer on a dump (PyQt6 when available,
               matplotlib fallback otherwise)
  bench        quick performance measurement

Example:
  python -m fluid_simulation.cli run --width 64 --height 32 --depth 32 \
      --steps 100 --sphere 24,16,16,6 --dump-dir /tmp/fsdata
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _add_sim_args(p):
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--depth", type=int, default=64)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--speed", type=float, default=30.0)
    p.add_argument("--dt", type=float, default=0.05)
    p.add_argument("--diff", type=float, default=2.0e-5)
    p.add_argument("--visc", type=float, default=1.5e-5)
    p.add_argument("--acc", type=int, default=15)
    p.add_argument("--solver", default="rbgs",
                   choices=["jacobi", "rbgs", "gs_wavefront"])
    p.add_argument("--mode", default="compat",
                   choices=["compat", "fast", "split"])
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--wall-mode", default="reference", choices=["reference", "noslip"])
    p.add_argument("--vorticity", type=float, default=0.0)
    p.add_argument("--no-pallas", action="store_true",
                   help="run the jnp sweeps instead of the fused GPU sweep "
                        "kernel")
    # scene
    p.add_argument("--stl", help="STL file to voxelize as the obstacle")
    p.add_argument("--stl-scale", type=float, default=1.0)
    p.add_argument("--stl-rot", default="0,0,0", help="rx,ry,rz degrees")
    p.add_argument("--stl-translate", default="0,0,0", help="tx,ty,tz cells")
    p.add_argument("--voxelizer", default="rasterize",
                   choices=["rasterize", "ray_parity"])
    p.add_argument("--sphere", help="cx,cy,cz,r analytic sphere obstacle")
    p.add_argument("--box", help="x0,x1,y0,y1,z0,z1 analytic box obstacle")
    p.add_argument("--cylinder", help="cx,cy,r z-aligned cylinder obstacle")


def _params_from(args):
    from fluid_simulation.config import SimParams
    return SimParams(
        width=args.width, height=args.height, depth=args.depth,
        dt=args.dt, diff=args.diff, visc=args.visc, acc=args.acc,
        speed=args.speed, solver=args.solver, mode=args.mode,
        dtype=args.dtype, wall_mode=args.wall_mode,
        vorticity=args.vorticity, use_pallas=not args.no_pallas)


def _obstacles_from(args, params):
    from fluid_simulation.scene.primitives import (
        empty_obstacles, add_sphere, add_box, add_cylinder)
    obs = empty_obstacles(params.width, params.height, params.depth)
    if args.sphere:
        cx, cy, cz, r = (float(v) for v in args.sphere.split(","))
        obs = add_sphere(obs, cx, cy, cz, r)
    if args.box:
        vals = [int(v) for v in args.box.split(",")]
        obs = add_box(obs, *vals)
    if args.cylinder:
        cx, cy, r = (float(v) for v in args.cylinder.split(","))
        obs = add_cylinder(obs, cx, cy, r)
    if args.stl:
        from fluid_simulation.config import SceneParams
        from fluid_simulation.scene.voxelize import load_stl_into_obstacles
        rx, ry, rz = (float(v) for v in args.stl_rot.split(","))
        tx, ty, tz = (float(v) for v in args.stl_translate.split(","))
        scene = SceneParams(stl_path=args.stl, scale=args.stl_scale,
                            rot_x=rx, rot_y=ry, rot_z=rz,
                            translate_x=tx, translate_y=ty, translate_z=tz,
                            voxelizer=args.voxelizer)
        obs = load_stl_into_obstacles(scene, obs)
    return obs


def cmd_run(args):
    from fluid_simulation.models.windtunnel import WindTunnel
    from fluid_simulation.io.dump import run_and_dump
    from fluid_simulation.io.checkpoint import save_checkpoint
    from fluid_simulation.utils.logging import StepLogger

    params = _params_from(args)
    obstacles = _obstacles_from(args, params)
    wt = WindTunnel(params, obstacles=obstacles)
    log = StepLogger(every=args.log_every)
    log.banner(params)

    t0 = time.time()
    if args.render_dir:
        from fluid_simulation.viz.export import render_live
        n = render_live(wt, args.steps, args.render_dir,
                        every=args.render_every, chunk=args.chunk)
        log.log.info("rendered %d on-device frames to %s", n, args.render_dir)
    elif args.dump_dir:
        run_and_dump(wt, args.steps, args.dump_dir, chunk=args.chunk)
    else:
        done = 0
        while done < args.steps:
            n = min(args.chunk, args.steps - done)
            _, stats = wt.simulate(steps=n)
            done += n
            s = np.asarray(stats.density_sum)
            d = np.asarray(stats.max_divergence)
            for i in range(n):
                log.step(done - n + i, float(s[i]), float(d[i]))
    dt_wall = time.time() - t0
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, wt.state, args.steps, params,
                        obstacles=wt.obstacles)
    log.final_stats(wt.state)
    cups = params.n_cells * args.steps / dt_wall
    log.log.info("%d steps in %.2fs  (%.1f steps/s, %.3g cell-updates/s)",
                 args.steps, dt_wall, args.steps / dt_wall, cups)
    return 0


def cmd_resume(args):
    from fluid_simulation.models.windtunnel import WindTunnel
    from fluid_simulation.io.checkpoint import load_checkpoint, save_checkpoint
    from fluid_simulation.utils.logging import StepLogger

    state, step0, params, obstacles = load_checkpoint(args.ckpt_dir)
    if params is None:
        print("checkpoint has no params.json", file=sys.stderr)
        return 1
    wt = WindTunnel(params, obstacles=obstacles)
    wt.state = state
    log = StepLogger(every=args.log_every)
    log.log.info("resumed at step %d", step0)
    wt.simulate(steps=args.steps)
    save_checkpoint(args.ckpt_dir, wt.state, step0 + args.steps, params,
                    obstacles=obstacles)
    log.final_stats(wt.state)
    return 0


def cmd_export_pngs(args):
    from fluid_simulation.viz.export import export_pngs
    n = export_pngs(args.data_dir, args.out_dir, z_slice=args.z_slice,
                    dims=_dims_opt(args))
    print(f"wrote {n} images to {args.out_dir}")
    return 0


def cmd_view(args):
    from fluid_simulation.viz.viewer2d import launch_viewer
    return launch_viewer(args.data_dir, dims=_dims_opt(args))


def cmd_view3d(args):
    """3-D viewer on a dump — the reference launcher's final stage
    (run.sh:4 -> GUI/main.py:11-41). PyQt6+OpenGL when available,
    matplotlib 3-D fallback otherwise (viewer3d.launch_viewer_3d)."""
    from fluid_simulation.viz.viewer3d import launch_viewer_3d
    return launch_viewer_3d(args.data_dir, dims=_dims_opt(args))


def _dims_opt(args):
    if args.dims:
        return tuple(int(v) for v in args.dims.split(","))
    return None


def cmd_bench(args):
    import bench as bench_mod  # repo-root bench.py
    bench_mod.main()
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="fluid_simulation")
    sub = ap.add_subparsers(dest="cmd", required=True)

    rp = sub.add_parser("run", help="run a simulation")
    _add_sim_args(rp)
    rp.add_argument("--dump-dir", help="write reference-contract .bin frames")
    rp.add_argument("--render-dir",
                    help="stream device-rendered slice PNGs instead of raw "
                         "frame dumps")
    rp.add_argument("--render-every", type=int, default=1)
    rp.add_argument("--ckpt-dir", help="write a checkpoint at the end")
    rp.add_argument("--chunk", type=int, default=10, help="scan burst size")
    rp.add_argument("--log-every", type=int, default=100)
    rp.set_defaults(fn=cmd_run)

    sp = sub.add_parser("resume", help="resume from latest checkpoint")
    sp.add_argument("--ckpt-dir", required=True)
    sp.add_argument("--steps", type=int, default=100)
    sp.add_argument("--log-every", type=int, default=100)
    sp.set_defaults(fn=cmd_resume)

    ep = sub.add_parser("export-pngs", help="render PNGs from a dump")
    ep.add_argument("--data-dir", default="data")
    ep.add_argument("--out-dir", default="pngs")
    ep.add_argument("--z-slice", type=int, default=None)
    ep.add_argument("--dims", help="W,H,D if no meta.json")
    ep.set_defaults(fn=cmd_export_pngs)

    vp = sub.add_parser("view", help="open the 2-D slice viewer")
    vp.add_argument("--data-dir", default="data")
    vp.add_argument("--dims", help="W,H,D if no meta.json")
    vp.set_defaults(fn=cmd_view)

    v3 = sub.add_parser("view3d", help="open the 3-D viewer "
                        "(iso-surface obstacle mesh + streamlines)")
    v3.add_argument("--data-dir", default="data")
    v3.add_argument("--dims", help="W,H,D if no meta.json")
    v3.set_defaults(fn=cmd_view3d)

    bp = sub.add_parser("bench", help="run the benchmark")
    bp.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    from fluid_simulation.utils.cache import enable_compile_cache
    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
