#!/usr/bin/env python3
"""Benchmark: the reference's headline workload plus the BASELINE config
matrix on one GPU.

Headline (the JSON ``value``) = BASELINE.md row "interior cell-updates/sec":
the 128x64x64 wind tunnel (same grid, inlet forcing, 15-sweep solves, two
projections per step) in ``mode='split'``. The reference measures 0.43e6
cell-updates/s on its hardware; ``vs_baseline`` is against that.

The ``configs`` dict:

- ``flagship_compat``: bit-level reference semantics (golden-parity mode).
- ``obstacle_sphere``: 128x64x64 + voxel sphere (BASELINE config 2 proxy).
- ``noslip_vorticity``: no-slip walls + vorticity confinement (config 3).
- ``sweep8``: 8 obstacle geometries in one program, auto-routed
  (config 4) — reported as geometry-steps/s.
- ``grid_256x128x128`` / ``grid_256x256x256`` / ``grid_512x256x256``: big
  grids (config 5's single-device proxy).
- ``obstacle_256x128x128`` / ``obstacle_256x256x256`` /
  ``obstacle_512x256x256``: big grid + voxel sphere. The spheres sit just
  downstream of the inlet (cx 16-24) so the few timed steps are
  numerically obstacle-sensitive: each obstacle config's final density_sum
  must differ from its empty twin (asserted).
- ``flagship_bf16``: bfloat16 state.
- ``parity_compat_100step``: UNTIMED 100-step compat run asserted against
  the reference's own printed stats (density sum 14125.1 +-1.5%, dens max
  0.0505 +-2% — BASELINE.md, simulation.cpp:73-90). Out-of-bounds numerics
  fail the whole bench (metric ``parity_failed``).

Each config reports ms/step, cell-updates/s, final density sum and the
post-projection divergence residual (max/mean, asserted < 20 / < 1.0);
failures are recorded as strings instead of killing the headline. Prints
ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
"configs"}. Exits 1 without a GPU.

Repetitions run inside one jitted lax.scan; slope timing cancels the fixed
per-dispatch overhead; best of several windows.
"""

import json
import sys
import time

import numpy as np

BASELINE_CELL_UPDATES_PER_SEC = 0.43e6  # BASELINE.md, measured reference


def main():
    from fluid_simulation.utils.cache import enable_compile_cache
    enable_compile_cache()
    import jax
    import jax.numpy as jnp
    from fluid_simulation.config import SimParams
    from fluid_simulation.models.windtunnel import (
        WindTunnel, residual_stats, simulation_step)
    from fluid_simulation.scene.primitives import (
        add_box, add_sphere, empty_obstacles)

    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {device}", file=sys.stderr)
        return 1
    print(f"# device: {device}", file=sys.stderr, flush=True)

    def slope_time(run_n, *args, reps=3, n=50):
        """(t(3n) - t(n)) / 2n — cancels the fixed per-dispatch
        overhead."""
        r1, r3 = run_n(n), run_n(3 * n)
        out = r1(*args)
        jax.block_until_ready(out)
        jax.block_until_ready(r3(*args))
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(r1(*args))
            t1 = time.perf_counter()
            jax.block_until_ready(r3(*args))
            t2 = time.perf_counter()
            best = min(best, ((t2 - t1) - (t1 - t0)) / (2 * n))
        return best, out

    def measure(params, obstacles=None, reps=3, n=50):
        """ms/step of the full jitted step under scan; final-state checks."""
        wt = WindTunnel(params, obstacles=obstacles)
        # WindTunnel upgrades empty_scene for obstacle-free scenes — time
        # the params a user's run actually executes
        params = wt.params
        masks = wt.masks

        def run_n(length):
            @jax.jit
            def run(state, m):
                def body(c, _):
                    c, _stats = simulation_step(c, m, params)
                    return c, None
                return jax.lax.scan(body, state, None, length=length)[0]
            return run

        best, state = slope_time(run_n, wt.state, masks, reps=reps, n=n)
        dens_sum = float(jnp.sum(state.dens, dtype=jnp.float32))
        assert np.isfinite(dens_sum) and dens_sum > 0, dens_sum
        dmax, dmean = (float(x) for x in residual_stats(state))
        # numerics bound: the reference's final frame measures 9.29 / 0.258
        # (BASELINE.md). A solver/kernel regression that breaks
        # incompressibility fails the bench, not just the CPU suite.
        assert np.isfinite(dmax) and dmax < 20.0, f"div residual max {dmax}"
        assert np.isfinite(dmean) and dmean < 1.0, f"div residual mean {dmean}"
        return best, dens_sum, (dmax, dmean), params

    configs = {}
    raw_sums = {}  # unrounded final density sums, for the twin guards

    def record(name, params, obstacles=None, reps=3, n=50):
        try:
            t, ds, (dmax, dmean), p = measure(params, obstacles, reps, n)
            raw_sums[name] = ds
            cu = p.n_cells / t
            configs[name] = {
                "ms_per_step": round(t * 1e3, 3),
                "cell_updates_per_sec": round(cu, 1),
                "vs_baseline": round(cu / BASELINE_CELL_UPDATES_PER_SEC, 1),
                "density_sum": round(ds, 2),
                "div_residual_max": round(dmax, 3),
                "div_residual_mean": round(dmean, 5),
            }
            print(f"# {name}: {t * 1e3:.2f} ms/step, {cu:.4g} cu/s "
                  f"({cu / BASELINE_CELL_UPDATES_PER_SEC:.1f}x baseline), "
                  f"density_sum={ds:.1f}, div_residual max={dmax:.2f} "
                  f"mean={dmean:.4f}", file=sys.stderr, flush=True)
            return t
        except Exception as e:  # record, keep benching
            configs[name] = f"error: {type(e).__name__}: {e}"
            print(f"# {name}: FAILED {type(e).__name__}: {e}",
                  file=sys.stderr, flush=True)
            return None

    # 128x64x64 reference defaults; like the reference, no residual pass
    # inside the timed loop (stats computed once on the final state)
    # per-step stats off: the reference sums density on the host every
    # 100 steps only (simulation.cpp:73-77); bench computes final-state
    # stats separately after timing
    base = SimParams(div_stats=False, step_stats=False)
    split = base.replace(mode="split")

    # --- numeric parity: one UNTIMED 100-step
    # compat run at the reference's own headline workload, asserted against
    # the stats the reference itself prints (simulation.cpp:73-90 density
    # sum; final min/max block): density sum 14125.1 +-1.5%, dens max
    # 0.0505 +-2% (BASELINE.md; our rbgs measures 14022.9 / 0.0505).
    # Out-of-bounds numerics FAIL the whole bench (exit via parity_failed).
    parity_ok = True
    try:
        wtp = WindTunnel(base)

        @jax.jit
        def run100(state, m):
            def body(c, _):
                c, _stats = simulation_step(c, m, wtp.params)
                return c, None
            return jax.lax.scan(body, state, None, length=100)[0]

        st = run100(wtp.state, wtp.masks)
        p_sum = float(jnp.sum(st.dens, dtype=jnp.float32))
        p_max = float(jnp.max(st.dens))
        # +-1.5% on the sum: the rbgs solver's ordering sits ~0.7% below the
        # reference's sequential-GS print, so 1.5% leaves ~2x margin for
        # reduction-order drift while still catching real numerics breaks
        # (dropping one projection shifts the sum ~8%)
        sum_ok = abs(p_sum - 14125.1) / 14125.1 <= 0.015
        max_ok = abs(p_max - 0.0505) / 0.0505 <= 0.02
        parity_ok = bool(sum_ok and max_ok)
        configs["parity_compat_100step"] = {
            "density_sum": round(p_sum, 2), "ref_density_sum": 14125.1,
            "dens_max": round(p_max, 5), "ref_dens_max": 0.0505,
            "ok": parity_ok,
        }
        print(f"# parity_compat_100step: density_sum={p_sum:.2f} "
              f"(ref 14125.1, {'OK' if sum_ok else 'OUT OF BOUNDS'}), "
              f"dens_max={p_max:.5f} (ref 0.0505, "
              f"{'OK' if max_ok else 'OUT OF BOUNDS'})",
              file=sys.stderr, flush=True)
    except Exception as e:  # environmental failure: record, keep benching
        configs["parity_compat_100step"] = f"error: {type(e).__name__}: {e}"
        print(f"# parity_compat_100step: FAILED {type(e).__name__}: {e}",
              file=sys.stderr, flush=True)

    if not parity_ok:
        print(json.dumps({"metric": "parity_failed", "value": 0.0,
                          "unit": "cell-updates/s", "vs_baseline": 0.0,
                          "device": device, "configs": configs}))
        return 1

    t_split = record("flagship_split", split, n=100)
    record("flagship_compat", base, reps=2, n=10)

    sphere = add_sphere(empty_obstacles(128, 64, 64), cx=40, cy=32, cz=32,
                        radius=10)
    record("obstacle_sphere", split, obstacles=np.asarray(sphere), n=50)
    record("noslip_vorticity",
           split.replace(wall_mode="noslip", vorticity=5.0), n=50)
    record("flagship_bf16", split.replace(dtype="bfloat16"), n=50)
    record("grid_256x128x128",
           SimParams(width=256, height=128, depth=128, div_stats=False,
                     step_stats=False, mode="split"), reps=2, n=10)
    big_sphere = add_sphere(empty_obstacles(256, 128, 128), cx=85, cy=64,
                            cz=64, radius=20)
    record("obstacle_256x128x128",
           SimParams(width=256, height=128, depth=128, div_stats=False,
                     step_stats=False, mode="split"),
           obstacles=np.asarray(big_sphere), reps=2, n=10)
    record("grid_256x256x256",
           SimParams(width=256, height=256, depth=256, div_stats=False,
                     step_stats=False, mode="split"), reps=2, n=4)
    # Sphere leading edge at x=8 (cx=48, r=40): the n=4 timed steps must
    # produce final stats that DIFFER from the empty twin (at cx=85 the flow
    # never reached the solid in 4 steps and the two configs were
    # bitwise-identical, hiding masked numerics)
    huge_sphere = add_sphere(empty_obstacles(256, 256, 256), cx=48, cy=128,
                             cz=128, radius=40)
    record("obstacle_256x256x256",
           SimParams(width=256, height=256, depth=256, div_stats=False,
                     step_stats=False, mode="split"),
           obstacles=np.asarray(huge_sphere), reps=2, n=4)
    record("grid_512x256x256",
           SimParams(width=512, height=256, depth=256, div_stats=False,
                     step_stats=False, mode="split"), reps=2, n=3)
    # sphere just downstream of the inlet for the same reason (n=3 steps)
    wide_sphere = add_sphere(empty_obstacles(512, 256, 256), cx=48,
                             cy=128, cz=128, radius=40)
    record("obstacle_512x256x256",
           SimParams(width=512, height=256, depth=256, div_stats=False,
                     step_stats=False, mode="split"),
           obstacles=np.asarray(wide_sphere), reps=2, n=3)

    # numeric obstacle-sensitivity guard: every obstacle config's final
    # density sum must differ from its empty twin — equal sums mean the
    # timed steps never numerically engaged the solid and a masked-path
    # numerics regression would be invisible. Unrounded sums.
    obstacle_blind = []
    for ob, em in (("obstacle_sphere", "flagship_split"),
                   ("obstacle_256x128x128", "grid_256x128x128"),
                   ("obstacle_256x256x256", "grid_256x256x256"),
                   ("obstacle_512x256x256", "grid_512x256x256")):
        if ob in raw_sums and em in raw_sums and raw_sums[ob] == raw_sums[em]:
            obstacle_blind.append(ob)
    if obstacle_blind:
        for name in obstacle_blind:
            print(f"# {name}: OBSTACLE-BLIND (density_sum identical to its "
                  f"empty twin)", file=sys.stderr, flush=True)
        configs["obstacle_blind"] = obstacle_blind
        print(json.dumps({"metric": "obstacle_blind", "value": 0.0,
                          "unit": "cell-updates/s", "vs_baseline": 0.0,
                          "device": device, "configs": configs}))
        return 1

    # BASELINE config 4: 8 geometries, one program, auto-routed
    try:
        from fluid_simulation.models.sweep import batch_masks, design_sweep
        geoms = [np.asarray(sphere)]
        e = empty_obstacles(128, 64, 64)
        for k in range(7):
            g = (add_sphere(e, 30 + 6 * k, 20 + 3 * k, 28, 5 + k % 3)
                 if k % 2 else add_box(e, 20 + 5 * k, 35 + 5 * k, 20, 40,
                                       24, 40))
            geoms.append(np.asarray(g))
        bm = jax.tree_util.tree_map(jnp.asarray, batch_masks(geoms))

        def run_n(length):
            def run(bm):
                return design_sweep(bm, split, steps=length)[0]
            return run
        best, _ = slope_time(run_n, bm, reps=2, n=4)
        gsps = 8.0 / best
        configs["sweep8"] = {"ms_per_batched_step": round(best * 1e3, 3),
                             "geometry_steps_per_sec": round(gsps, 1)}
        print(f"# sweep8: {best * 1e3:.2f} ms/batched-step = {gsps:.0f} "
              f"geometry-steps/s (auto route)", file=sys.stderr, flush=True)
    except Exception as e:
        configs["sweep8"] = f"error: {type(e).__name__}: {e}"
        print(f"# sweep8: FAILED {type(e).__name__}: {e}", file=sys.stderr,
              flush=True)

    if t_split is None:
        print(json.dumps({"metric": "bench_failed", "value": 0.0,
                          "unit": "cell-updates/s", "vs_baseline": 0.0,
                          "device": device, "configs": configs}))
        return 1
    cell_updates = base.n_cells / t_split
    result = {
        "metric": "cell_updates_per_sec_128x64x64_wind_tunnel",
        "value": round(cell_updates, 1),
        "unit": "cell-updates/s",
        "vs_baseline": round(cell_updates / BASELINE_CELL_UPDATES_PER_SEC, 2),
        "device": device,
        "configs": configs,
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
