#!/usr/bin/env python3
"""Print a fidelity report of this framework against the reference.

Runs the compat solver on CPU against the golden fixtures captured from the
compiled, unmodified reference binary (tests/golden/, regenerate with
tools/make_goldens.py) and prints a comparison table:

  - step-1 / step-5 pointwise agreement (pre-chaos, near-ulp)
  - per-step mass trajectory error
  - final-state moment agreement (chaotic regime)
  - the reference's headline 128x64x64 statistics (optional, --headline;
    ~2 min on CPU)

Usage: python tools/parity_report.py [--headline]
"""

import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def _setup_jax():
    import jax
    try:
        jax.config.update("jax_platforms", "cpu")
    except Exception:
        pass


def report_scenario(name, obstacles=None):
    from fluid_simulation.config import SimParams
    from fluid_simulation.models.windtunnel import WindTunnel

    path = os.path.join(os.path.dirname(__file__), "..", "tests", "golden",
                        name + ".npz")
    if not os.path.exists(path):
        print(f"  [missing golden {name}; run tools/make_goldens.py]")
        return
    g = np.load(path)
    p = SimParams(width=int(g["W"]), height=int(g["H"]), depth=int(g["D"]),
                  solver="gs_wavefront")
    wt = WindTunnel(p, obstacles=obstacles)
    sums = []
    state5 = None
    for i in range(int(g["steps"])):
        stats = wt.step()
        sums.append(float(stats.density_sum))
        if i == 4:
            state5 = wt.state
    sums = np.asarray(sums, np.float64)

    print(f"  {name}:")
    d5 = np.abs(np.asarray(state5.vx) - g["vx_step5"]).max()
    print(f"    step-5 vx max |diff| vs C++ binary : {d5:.2e}")
    rel = np.abs(sums - g["dens_sums"]) / g["dens_sums"]
    print(f"    mass trajectory rel err            : "
          f"pre-chaos {rel[:8].max():.2e}, overall {rel.max():.2e}")
    for key, mine in (("vx_final", wt.state.vx), ("dens_final", wt.state.dens)):
        a = np.asarray(mine, np.float64)
        r = g[key].astype(np.float64)
        m_err = abs(np.abs(a).mean() - np.abs(r).mean()) / np.abs(r).mean()
        print(f"    final {key.split('_')[0]} mean|.| rel err"
              f"          : {m_err:.2e}")
    if "div_max" in g.files:
        from tools.make_goldens import div_residual_grid_units
        obs = np.asarray(g["obs"], np.float32)
        dmax, dmean = div_residual_grid_units(
            np.asarray(wt.state.vx), np.asarray(wt.state.vy),
            np.asarray(wt.state.vz), obs)
        print(f"    div residual (grid units)          : "
              f"max {dmax:.3f} / mean {dmean:.4f} "
              f"(reference {float(g['div_max']):.3f} / "
              f"{float(g['div_mean']):.4f})")


def headline():
    """The reference's own console statistics at its default configuration
    (BASELINE.md: density sum 14125.1, dens max 0.0505...)."""
    from fluid_simulation.config import SimParams
    from fluid_simulation.models.windtunnel import WindTunnel

    wt = WindTunnel(SimParams())  # rbgs default
    wt.simulate(steps=100)
    r = wt.field_ranges()
    print("  128x64x64 x 100 steps (rbgs) vs reference console:")
    print(f"    density sum : {wt.density_sum():.1f}   (reference 14125.1)")
    print(f"    dens max    : {r['density'][1]:.4f}   (reference 0.0505)")
    print(f"    vx range    : [{r['vx'][0]:.2f}, {r['vx'][1]:.2f}]"
          f"   (reference [-10.24, 28.61])")
    # BASELINE.md residual row (final frame, central diff, grid units):
    # reference measured max 9.29, mean 0.258 from its own dump
    from tools.make_goldens import div_residual_grid_units
    p = wt.params
    dmax, dmean = div_residual_grid_units(
        np.asarray(wt.state.vx), np.asarray(wt.state.vy),
        np.asarray(wt.state.vz), np.zeros(p.padded_shape, np.float32))
    print(f"    div residual: max {dmax:.2f} / mean {dmean:.4f}"
          f"   (reference 9.29 / 0.258)")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--headline", action="store_true",
                    help="also run the 128x64x64 headline comparison (~2 min)")
    args = ap.parse_args()
    _setup_jax()

    from fluid_simulation.scene.primitives import add_box, empty_obstacles

    print("Fidelity report (compat semantics, wavefront-GS solver vs the")
    print("compiled reference binary at OMP_NUM_THREADS=1):")
    report_scenario("empty_32x16x16")
    report_scenario("box_32x16x16",
                    obstacles=add_box(empty_obstacles(32, 16, 16),
                                      10, 15, 6, 9, 6, 9))
    if args.headline:
        headline()
    return 0


if __name__ == "__main__":
    sys.exit(main())
