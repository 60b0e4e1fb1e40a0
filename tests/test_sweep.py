"""Batched design sweep (BASELINE config 4): vmapped scenes == individual."""

import numpy as np
import pytest

from fluid_simulation.config import SimParams
from fluid_simulation.models.sweep import (
    auto_route, batch_masks, design_sweep, drag_proxy)
from fluid_simulation.models.windtunnel import WindTunnel
from fluid_simulation.scene.primitives import (
    add_box, add_sphere, empty_obstacles)

P = SimParams(width=16, height=8, depth=8, acc=5)


def _geometries():
    # 8 obstacle geometries in one vmapped batch (BASELINE config 4)
    base = empty_obstacles(16, 8, 8)
    return [
        base,
        add_sphere(base, 8, 4, 4, 2.0),
        add_box(base, 6, 9, 3, 5, 3, 5),
        add_sphere(base, 6, 4, 4, 1.5),
        add_sphere(base, 10, 5, 4, 1.8),
        add_box(base, 4, 6, 2, 6, 2, 6),
        add_sphere(base, 8, 3, 5, 1.2),
        add_box(base, 9, 12, 4, 6, 3, 5),
    ]


def test_design_sweep_matches_individual_runs():
    geoms = _geometries()
    bm = batch_masks(geoms)
    final, stats = design_sweep(bm, P, steps=4)
    sums = np.asarray(stats.density_sum)       # (steps, B)
    assert sums.shape == (4, len(geoms))

    for b, obs in enumerate(geoms):
        wt = WindTunnel(P, obstacles=obs)
        _, st = wt.simulate(steps=4)
        np.testing.assert_allclose(sums[:, b], np.asarray(st.density_sum),
                                   rtol=2e-5)
        for leaf_batch, leaf in zip(final, wt.state):
            a = np.asarray(leaf_batch)[b]
            r = np.asarray(leaf)
            np.testing.assert_allclose(a, r, atol=5e-5 * (np.abs(r).max() + 1e-9))


def test_sweep_routes_agree():
    """Auto-routing (VERDICT r2 #6): both execution routes of the batch axis
    run the same step and must agree; 'auto' must resolve to one of them."""
    geoms = _geometries()[:3]
    bm = batch_masks(geoms)
    f_v, s_v = design_sweep(bm, P, steps=3, route="vmap")
    f_m, s_m = design_sweep(bm, P, steps=3, route="map")
    # map route == vmap route bitwise: both run the batched=True step
    np.testing.assert_array_equal(np.asarray(s_m.density_sum),
                                  np.asarray(s_v.density_sum))
    assert np.asarray(s_m.density_sum).shape == (3, 3)   # (steps, B)
    for a, b in zip(f_m, f_v):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert auto_route(P) == "vmap"
    with pytest.raises(ValueError):
        design_sweep(bm, P, steps=1, route="sequential")


@pytest.mark.parametrize("grid,route", [
    ((16, 8, 8), "vmap"), ((128, 64, 64), "vmap"),
    ((256, 128, 128), "map"), ((512, 256, 256), "map")])
def test_auto_route(grid, route):
    """'auto' takes vmap up to the flagship and map on the larger grids,
    where map measured faster; it never unrolls."""
    W, H, D = grid
    assert auto_route(SimParams(width=W, height=H, depth=D)) == route


def test_drag_proxy_orders_geometries():
    geoms = _geometries()
    bm = batch_masks(geoms)
    final, _ = design_sweep(bm, P, steps=8)
    import jax
    drags = np.asarray(jax.vmap(lambda s: drag_proxy(s, P))(final))
    assert drags.shape == (len(geoms),)
    assert np.all(np.isfinite(drags))
    # the empty tunnel must have the least momentum deficit of all geometries
    assert np.argmin(drags) == 0
