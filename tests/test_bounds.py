"""set_bounds semantics (vs simulation.cpp:183-246), asserted structurally."""

import numpy as np
import jax.numpy as jnp
import pytest

from fluid_simulation.ops.bounds import set_bounds
from fluid_simulation.scene.masks import build_masks
from fluid_simulation.scene.primitives import empty_obstacles, add_box

W, H, D = 8, 6, 5


def _rand_field(seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.normal(size=(D + 2, H + 2, W + 2)).astype(np.float32))


def _masks(obs=None):
    if obs is None:
        obs = empty_obstacles(W, H, D)
    return build_masks(jnp.asarray(obs))


@pytest.mark.parametrize("b", [0, 1, 2, 3])
def test_faces(b):
    f0 = _rand_field()
    f = np.asarray(set_bounds(b, f0, _masks()))
    sx = -1.0 if b == 1 else 1.0
    sy = -1.0 if b == 2 else 1.0
    sz = -1.0 if b == 3 else 1.0
    ref = np.asarray(f0)
    # x- mirror (negated for b=1), x+ ALWAYS outflow copy (simulation.cpp:189-191)
    np.testing.assert_array_equal(f[1:-1, 1:-1, 0], sx * ref[1:-1, 1:-1, 1])
    np.testing.assert_array_equal(f[1:-1, 1:-1, -1], ref[1:-1, 1:-1, -2])
    np.testing.assert_array_equal(f[1:-1, 0, 1:-1], sy * ref[1:-1, 1, 1:-1])
    np.testing.assert_array_equal(f[1:-1, -1, 1:-1], sy * ref[1:-1, -2, 1:-1])
    np.testing.assert_array_equal(f[0, 1:-1, 1:-1], sz * ref[1, 1:-1, 1:-1])
    np.testing.assert_array_equal(f[-1, 1:-1, 1:-1], sz * ref[-2, 1:-1, 1:-1])
    # interior untouched for empty scene
    np.testing.assert_array_equal(f[1:-1, 1:-1, 1:-1], ref[1:-1, 1:-1, 1:-1])


def test_ghost_edges_never_written():
    f0 = _rand_field(1)
    f = np.asarray(set_bounds(1, f0, _masks()))
    ref = np.asarray(f0)
    # ghost edges/corners keep their values (reference never writes them)
    np.testing.assert_array_equal(f[0, 0, :], ref[0, 0, :])
    np.testing.assert_array_equal(f[0, :, 0], ref[0, :, 0])
    np.testing.assert_array_equal(f[:, 0, 0], ref[:, 0, 0])
    np.testing.assert_array_equal(f[-1, -1, -1], ref[-1, -1, -1])


def test_obstacle_zeroing_and_noslip_ring():
    obs = add_box(empty_obstacles(W, H, D), 3, 4, 2, 3, 2, 3)
    masks = _masks(obs)
    f0 = _rand_field(2) + 10.0  # keep away from zero

    # scalar (b=0): zero inside solids only (simulation.cpp:218-223)
    fs = np.asarray(set_bounds(0, f0, masks))
    solid = np.asarray(obs) >= 0.5
    assert np.all(fs[solid] == 0.0)
    interior_fluid = ~solid.copy()
    interior_fluid[0] = interior_fluid[-1] = False
    assert np.count_nonzero(fs[1:-1, 1:-1, 1:-1]) > 0

    # velocity (b=1): also zero on the 6-adjacent fluid ring (simulation.cpp:226-245)
    fv = np.asarray(set_bounds(1, f0, masks))
    assert np.all(fv[solid] == 0.0)
    adj = np.zeros_like(solid)
    s = solid
    adj[1:-1, 1:-1, 1:-1] = (
        s[1:-1, 1:-1, 2:] | s[1:-1, 1:-1, :-2]
        | s[1:-1, 2:, 1:-1] | s[1:-1, :-2, 1:-1]
        | s[2:, 1:-1, 1:-1] | s[:-2, 1:-1, 1:-1]
    ) & ~s[1:-1, 1:-1, 1:-1]
    assert np.all(fv[adj] == 0.0)
    # but scalar pass must NOT zero the ring
    assert np.all(fs[adj] != 0.0)


def test_noslip_wall_mode():
    f0 = _rand_field(3)
    f = np.asarray(set_bounds(2, f0, _masks(), wall_mode="noslip"))
    ref = np.asarray(f0)
    # every velocity component mirrors negated at y and z walls
    np.testing.assert_array_equal(f[1:-1, 0, 1:-1], -ref[1:-1, 1, 1:-1])
    np.testing.assert_array_equal(f[0, 1:-1, 1:-1], -ref[1, 1:-1, 1:-1])
    # x+ stays outflow
    np.testing.assert_array_equal(f[1:-1, 1:-1, -1], ref[1:-1, 1:-1, -2])
