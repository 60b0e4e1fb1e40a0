#!/usr/bin/env python3
"""Smoke test of the wind tunnel on one GPU, through the public entry points.

Phases, each of which exits non-zero on failure:

1. device    JAX must see a GPU (never falls back to the CPU); prints
             ``nvidia-smi --query-gpu=name,power.limit``.
2. parity    ``WindTunnel(SimParams())`` — the reference's 128x64x64 compat
             run — for 100 steps through ``simulate``: density sum within
             14125.1 +-1.5% and dens max within 0.0505 +-2% (the reference's
             own printed stats, BASELINE.md).
3. big grid  512x256x256 split with the bench's sphere and its empty twin,
             a few steps: finite fields, divergence residual max < 20 and
             mean < 1.0, and a density sum that differs from the twin's.
4. cli       ``cli.main(["run", ...])`` in this process at 128x64x64 with
             ``--dump-dir``: five .bin files of (W+2)(H+2)(D+2)*4*steps bytes
             and a meta.json that matches the grid.
5. kernel    the fused sweep kernel against the jnp sweep: one 15-sweep
             solve at 128x64x64 and 512x256x256, every b, both wall modes,
             empty and masked, float32 and bfloat16; max |diff| <= 1e-5 *
             max |f| for float32 and <= 1e-2 * max |f| for bfloat16.

``--multi`` runs only the four-card path instead: ``ShardedWindTunnel`` on a
1-D z mesh and a (2, 2) mesh, 256x128x128 with a sphere, split and compat,
20 steps, against the one-card ``WindTunnel`` in the same process: every
field within 1e-4 * max |field| after 2 steps, and the step-20 density sums
within 1e-4 relative (the flow is chaotic; see ``phase_multi``).

Everything runs in this one process. The last line of standard output is
``{"ok": true, "device": {"platform", "kind", "count"}}``.

Usage: python chip_smoke.py [--multi]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def say(msg):
    print(msg, flush=True)


def phase_device(n_devices):
    import jax
    devs = jax.devices()
    d = devs[0]
    check(d.platform == "gpu",
          f"JAX found no GPU (platform {d.platform!r})")
    check(len(devs) >= n_devices, f"need {n_devices} GPUs, found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    for line in smi.stdout.strip().splitlines()[:n_devices]:
        say(f"card: {line.strip()}")
    say(f"jax: {d.platform} {d.device_kind} x{len(devs)}")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


def phase_parity():
    from fluid_simulation import SimParams, WindTunnel
    t0 = time.perf_counter()
    wt = WindTunnel(SimParams())
    wt.simulate(steps=100)
    dsum = wt.density_sum()
    dmax = wt.field_ranges()["density"][1]
    say(f"parity: 128x64x64 compat 100 steps density_sum={dsum:.2f} "
        f"(ref 14125.1 +-1.5%) dens_max={dmax:.5f} (ref 0.0505 +-2%) "
        f"[{time.perf_counter() - t0:.1f} s]")
    check(abs(dsum - 14125.1) <= 0.015 * 14125.1, f"density sum {dsum}")
    check(abs(dmax - 0.0505) <= 0.02 * 0.0505, f"dens max {dmax}")


def bench_sphere(W, H, D):
    from fluid_simulation.scene.primitives import add_sphere, empty_obstacles
    if (W, H, D) == (128, 64, 64):
        return add_sphere(empty_obstacles(W, H, D), cx=40, cy=32, cz=32,
                          radius=10)
    return add_sphere(empty_obstacles(W, H, D), cx=min(48, W // 3),
                      cy=H // 2, cz=D // 2, radius=min(40, H // 4))


def phase_big_grid(W=512, H=256, D=256, steps=3):
    import jax
    import jax.numpy as jnp
    from fluid_simulation import SimParams, WindTunnel
    from fluid_simulation.models.windtunnel import residual_stats
    from fluid_simulation.scene.primitives import empty_obstacles
    p = SimParams(width=W, height=H, depth=D, mode="split",
                  div_stats=False, step_stats=False)
    finite = jax.jit(lambda s: jnp.all(jnp.stack(
        [jnp.all(jnp.isfinite(f)) for f in s])))
    sums = {}
    for name, obs in (("sphere", bench_sphere(W, H, D)),
                      ("empty", empty_obstacles(W, H, D))):
        t0 = time.perf_counter()
        wt = WindTunnel(p, obstacles=obs)
        wt.simulate(steps=steps)
        ok = bool(finite(wt.state))
        dmax, dmean = (float(v) for v in residual_stats(wt.state))
        sums[name] = wt.density_sum()
        say(f"big grid: {W}x{H}x{D} split {name} {steps} steps "
            f"finite={ok} div_residual max={dmax:.3f} mean={dmean:.5f} "
            f"density_sum={sums[name]!r} [{time.perf_counter() - t0:.1f} s]")
        check(ok, f"non-finite fields ({name})")
        check(dmax < 20.0 and dmean < 1.0,
              f"divergence residual {dmax}/{dmean} ({name})")
        del wt
    check(sums["sphere"] != sums["empty"],
          "sphere run has the empty twin's density sum (obstacle-blind)")


def phase_cli(steps=5):
    from fluid_simulation import cli
    from fluid_simulation.io.dump import FIELD_FILES
    W, H, D = 128, 64, 64
    out = tempfile.mkdtemp(prefix=".smoke_dump_", dir=ROOT)
    try:
        t0 = time.perf_counter()
        rc = cli.main(["run", "--width", str(W), "--height", str(H),
                       "--depth", str(D), "--steps", str(steps),
                       "--sphere", "40,32,32,10", "--dump-dir", out])
        check(rc == 0, f"cli run returned {rc}")
        frame = (W + 2) * (H + 2) * (D + 2) * 4
        sizes = {fn: os.path.getsize(os.path.join(out, fn))
                 for _, fn in FIELD_FILES}
        with open(os.path.join(out, "meta.json")) as f:
            meta = json.load(f)
        say(f"cli: run --dump-dir {steps} steps: "
            + " ".join(f"{fn}={n}" for fn, n in sizes.items())
            + f" (expect {frame * steps} each), meta padded_shape="
            f"{meta['padded_shape']} [{time.perf_counter() - t0:.1f} s]")
        check(all(n == frame * steps for n in sizes.values()),
              f"dump sizes {sizes}")
        check(meta["padded_shape"] == [D + 2, H + 2, W + 2]
              and (meta["width"], meta["height"], meta["depth"]) == (W, H, D),
              f"meta.json {meta}")
    finally:
        shutil.rmtree(out, ignore_errors=True)


def phase_kernel(grids=((128, 64, 64), (512, 256, 256))):
    import jax
    import jax.numpy as jnp
    from fluid_simulation.ops.linsolve import diffusion_coeffs, linear_solver
    from fluid_simulation.scene.masks import build_masks
    from fluid_simulation.scene.primitives import empty_obstacles

    rel = jax.jit(lambda x, y: jnp.max(jnp.abs(
        x.astype(jnp.float32) - y.astype(jnp.float32)))
        / jnp.max(jnp.abs(y.astype(jnp.float32))))
    tol = {"float32": 1e-5, "bfloat16": 1e-2}
    for W, H, D in grids:
        shape = (D + 2, H + 2, W + 2)
        a, c = diffusion_coeffs(W, H, D, 0.05, 2.0e-5)
        for dtype in (jnp.float32, jnp.bfloat16):
            name = jnp.dtype(dtype).name
            kf, kp = jax.random.split(jax.random.PRNGKey(0))
            rand = jax.jit(lambda k: jax.random.normal(k, shape, dtype))
            f, prev = rand(kf), rand(kp)
            for masked in (False, True):
                obs = (bench_sphere(W, H, D) if masked
                       else empty_obstacles(W, H, D))
                masks = build_masks(np.asarray(obs, np.float32), dtype=dtype)
                t0 = time.perf_counter()
                worst = 0.0
                for wall in ("reference", "noslip"):
                    for b in range(4):
                        aa, cc = (1.0, 6.0) if b == 0 else (a, c)
                        outs = [jax.jit(
                            lambda f, p, m, k=k: linear_solver(
                                b, f, p, aa, cc, m, acc=15, wall_mode=wall,
                                use_pallas=k, empty_scene=not masked))(
                                    f, prev, masks) for k in (True, False)]
                        r = float(rel(*outs))
                        worst = max(worst, r)
                        check(r <= tol[name],
                              f"kernel vs jnp {W}x{H}x{D} {name} "
                              f"masked={masked} {wall} b={b}: {r:.3g}")
                say(f"kernel: {W}x{H}x{D} {name} "
                    f"{'masked' if masked else 'empty'} b=0..3 x 2 wall "
                    f"modes: max|diff|/max|f| = {worst:.3g} "
                    f"(limit {tol[name]:g}) [{time.perf_counter() - t0:.1f} s]")


def phase_multi(W=256, H=128, D=128, steps=20, chunk=2, n=4):
    """Sharded runs against the one-card run. The two programs are bitwise
    equal through the diffusions and the first projection; they first
    differ by an ulp in the advection lerps, where the compiler contracts a
    different multiply-add into an FMA (tools/sharded_phase_diff.py). The
    flow is chaotic: on the CPU that ulp grows ~2.7x per step (1e-5 of
    max|field| at step 5, O(1) pointwise at step 20, at 128x64x64), so
    fields are compared pointwise after the first ``chunk`` steps and the
    total density after ``steps``. Four H100s gave 2.4e-5 to 5.4e-5 and
    5.5e-7 to 1.1e-5 for the two; the limits are 1e-4 for both."""
    import jax
    import jax.numpy as jnp
    from fluid_simulation import SimParams, WindTunnel
    from fluid_simulation.parallel.sharded import ShardedWindTunnel

    obs = bench_sphere(W, H, D)

    def run(tunnel, state_of):
        """Fields after the first chunk, and the float64 density sum after
        ``steps`` steps (host sums, so reduction order does not count)."""
        tunnel.simulate(steps=chunk)
        early = [np.asarray(f) for f in state_of(tunnel)]
        for _ in range(steps // chunk - 1):
            tunnel.simulate(steps=chunk)
        final = [np.asarray(f) for f in state_of(tunnel)]
        check(all(np.isfinite(f).all() for f in final), "non-finite fields")
        return early, float(np.sum(final[3], dtype=np.float64))

    for mode in ("split", "compat"):
        p = SimParams(width=W, height=H, depth=D, mode=mode)
        t0 = time.perf_counter()
        ref_early, ref_sum = run(WindTunnel(p, obstacles=obs),
                                 lambda t: t.state)
        for mesh_shape in ((n, 1), (2, n // 2)):
            sw = ShardedWindTunnel(p, obstacles=obs, n_devices=n,
                                   mesh_shape=mesh_shape)
            early, dsum = run(sw, lambda t: t.global_state())
            worst = max(
                float(np.max(np.abs(g - r)) / (np.max(np.abs(r)) + 1e-30))
                for g, r in zip(early, ref_early))
            sum_rel = abs(dsum - ref_sum) / abs(ref_sum)
            say(f"multi: {W}x{H}x{D} {mode} mesh {mesh_shape} vs one card: "
                f"step {chunk} max|diff|/max|field| = {worst:.3g} (limit "
                f"1e-4); step {steps} density-sum rel diff = {sum_rel:.3g} "
                f"(limit 1e-4) [{time.perf_counter() - t0:.1f} s]")
            check(worst <= 1e-4, f"sharded {mode} {mesh_shape}: {worst}")
            check(sum_rel <= 1e-4,
                  f"sharded {mode} {mesh_shape} sums: {sum_rel}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card sharded path")
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    from fluid_simulation.utils.cache import enable_compile_cache
    enable_compile_cache()

    t0 = time.perf_counter()
    device = phase_device(4 if args.multi else 1)
    if args.multi:
        phase_multi()
    else:
        phase_parity()
        phase_big_grid()
        phase_cli()
        phase_kernel()
    say(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
