"""Linear solver: wavefront GS == sequential GS; all solvers share the fixed
point; diffusion coefficients match the reference's f32 arithmetic."""

import itertools

import numpy as np
import jax.numpy as jnp
import pytest

import numpy_ref
from fluid_simulation.ops.linsolve import (
    linear_solver, diffusion_coeffs)
from fluid_simulation.scene.masks import build_masks
from fluid_simulation.scene.primitives import add_box, empty_obstacles

W, H, D = 6, 5, 4


def _setup(seed=0):
    rng = np.random.default_rng(seed)
    prev = rng.normal(size=(D + 2, H + 2, W + 2)).astype(np.float32)
    f = rng.normal(size=(D + 2, H + 2, W + 2)).astype(np.float32)
    masks = build_masks(jnp.asarray(empty_obstacles(W, H, D)))
    return jnp.asarray(f), jnp.asarray(prev), masks


def test_wavefront_matches_sequential_gs():
    f, prev, masks = _setup()
    a, c = 0.7, 1.0 + 6.0 * 0.7
    got = np.asarray(linear_solver(0, f, prev, a, c, masks, acc=3,
                                   solver="gs_wavefront"))
    # the oracle is the reference's own loop nest (tests/numpy_ref.py)
    want = numpy_ref.solve("gs_wavefront", 0, np.asarray(f),
                           np.asarray(prev), a, c, acc=3)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_solvers_share_fixed_point():
    f, prev, masks = _setup(1)
    a, c = 0.5, 4.0
    sols = {
        s: np.asarray(linear_solver(0, f, prev, a, c, masks, acc=200, solver=s))
        for s in ("jacobi", "rbgs", "gs_wavefront")
    }
    np.testing.assert_allclose(sols["jacobi"], sols["rbgs"], atol=1e-4)
    np.testing.assert_allclose(sols["rbgs"], sols["gs_wavefront"], atol=1e-4)


def test_rbgs_converges_faster_than_jacobi():
    f, prev, masks = _setup(2)
    a, c = 1.0, 6.0

    def resid(sol):
        s = (
            sol[1:-1, 1:-1, 2:] + sol[1:-1, 1:-1, :-2]
            + sol[1:-1, 2:, 1:-1] + sol[1:-1, :-2, 1:-1]
            + sol[2:, 1:-1, 1:-1] + sol[:-2, 1:-1, 1:-1])
        prev_i = np.asarray(prev)[1:-1, 1:-1, 1:-1]
        return float(np.abs(sol[1:-1, 1:-1, 1:-1] - (prev_i + a * s) / c).max())

    rj = resid(np.asarray(linear_solver(0, f, prev, a, c, masks, acc=8, solver="jacobi")))
    rr = resid(np.asarray(linear_solver(0, f, prev, a, c, masks, acc=8, solver="rbgs")))
    assert rr < rj


def test_diffusion_coeffs_reference_arithmetic():
    # a = dt*diff*W*H*D at the default 128x64x64 (simulation.cpp:282)
    a, c = diffusion_coeffs(128, 64, 64, 0.05, 2.0e-5)
    assert np.isclose(a, 0.524288, rtol=1e-6)
    assert np.isclose(c, 1.0 + 6.0 * 0.524288, rtol=1e-6)


@pytest.mark.parametrize(
    "solver,b,wall_mode,masked",
    list(itertools.product(("rbgs", "jacobi", "gs_wavefront"), (0, 1, 2, 3),
                           ("reference", "noslip"), (False, True))))
def test_solver_matches_numpy_oracle(solver, b, wall_mode, masked):
    """Each jnp solver ordering, with setBounds after every sweep, against
    the NumPy oracle (tests/numpy_ref.py) for every field tag, both wall
    modes, with and without a solid."""
    obs = empty_obstacles(W, H, D)
    if masked:
        obs = add_box(obs, 3, 4, 2, 3, 2, 3)
    masks = build_masks(jnp.asarray(obs))
    rng = np.random.default_rng(b + 10 * masked)
    f = rng.normal(size=(D + 2, H + 2, W + 2)).astype(np.float32)
    prev = rng.normal(size=(D + 2, H + 2, W + 2)).astype(np.float32)
    a, c = (1.0, 6.0) if b == 0 else (0.7, 1.0 + 6.0 * 0.7)
    got = np.asarray(linear_solver(b, jnp.asarray(f), jnp.asarray(prev), a,
                                   c, masks, acc=3, solver=solver,
                                   wall_mode=wall_mode,
                                   empty_scene=not masked))
    keep = None
    if masked:
        ks, kv = numpy_ref.keep_masks(obs)
        keep = kv if b in (1, 2, 3) else ks
    want = numpy_ref.solve(solver, b, f, prev, a, c, keep, wall_mode, acc=3)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
