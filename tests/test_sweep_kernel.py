"""The fused red-black sweep kernel (kernels/rbgs_sweep.py) against the jnp
sweep, in Pallas interpret mode on the CPU; the choice of kernel in
linear_solver; and, on a GPU only, the compiled kernel."""

import itertools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from fluid_simulation.kernels import rbgs_sweep as rs
from fluid_simulation.ops.linsolve import diffusion_coeffs, linear_solver
from fluid_simulation.scene.masks import build_masks
from fluid_simulation.scene.primitives import add_sphere, empty_obstacles

# padded (8, 9, 15): the default (4, 128) launch shape leaves partial tiles
# along both the plane (135 cells) and z
W, H, D = 13, 7, 6


def _case(masked, dtype, seed=0):
    obs = (add_sphere(empty_obstacles(W, H, D), 6, 3, 3, 2.0) if masked
           else empty_obstacles(W, H, D))
    masks = build_masks(np.asarray(obs, np.float32), dtype=dtype)
    rng = np.random.default_rng(seed)
    shape = (D + 2, H + 2, W + 2)
    f = jnp.asarray(rng.normal(size=shape), dtype)   # random ghosts too
    prev = jnp.asarray(rng.normal(size=shape), dtype)
    return f, prev, masks


def _keep(masks, b, masked):
    if not masked:
        return None
    return masks.keep_vel if b in (1, 2, 3) else masks.keep_scalar


def _coeffs(b):
    return (1.0, 6.0) if b == 0 else diffusion_coeffs(W, H, D, 0.05, 2e-3)


@pytest.mark.parametrize(
    "b,wall_mode,masked,dtype",
    list(itertools.product((0, 1, 2, 3), ("reference", "noslip"),
                           (False, True), ("float32", "bfloat16"))))
def test_sweep_matches_jnp_sweep(b, wall_mode, masked, dtype):
    """One kernel sweep == one jnp rbgs sweep + set_bounds, bitwise: same
    operand order per cell, and face/edge/keep handling of set_bounds."""
    dt = jnp.dtype(dtype)
    f, prev, masks = _case(masked, dt, seed=b)
    a, c = _coeffs(b)
    want = linear_solver(b, f, prev, a, c, masks, acc=1, wall_mode=wall_mode,
                         empty_scene=not masked)
    got = rs.rbgs_sweep(b, f, prev, _keep(masks, b, masked), a, c, wall_mode,
                        interpret=True)
    assert got.dtype == dt and got.shape == f.shape
    np.testing.assert_array_equal(np.asarray(got, np.float32),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("block", [(1, 16), (2, 32), (8, 64), (16, 256),
                                   (1, 1024)])
def test_sweep_launch_shapes(block):
    """Blocks smaller and larger than the plane and than the depth all give
    the same field (clamped lanes store their own cell's value)."""
    f, prev, masks = _case(True, jnp.float32, seed=7)
    a, c = _coeffs(1)
    want = linear_solver(1, f, prev, a, c, masks, acc=1)
    got = rs.rbgs_sweep(1, f, prev, masks.keep_vel, a, c, block=block,
                        interpret=True)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("b,masked", [(0, False), (0, True), (2, False),
                                      (2, True)])
def test_fifteen_sweep_solve_matches_jnp(b, masked):
    """A whole 15-sweep solve (the step's unit) stays bitwise equal."""
    f, prev, masks = _case(masked, jnp.float32, seed=11 + b)
    a, c = _coeffs(b)
    keep = _keep(masks, b, masked)
    got = jax.lax.scan(
        lambda fc, _: (rs.rbgs_sweep(b, fc, prev, keep, a, c,
                                     interpret=True), None),
        f, None, length=15)[0]
    want = linear_solver(b, f, prev, a, c, masks, acc=15,
                         empty_scene=not masked)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("masked", [False, True])
def test_sweep_under_vmap(masked):
    """design_sweep's vmap route batches the kernel: the batched call
    equals per-geometry jnp sweeps."""
    cases = [_case(masked, jnp.float32, seed=s) for s in (1, 2)]
    f = jnp.stack([c[0] for c in cases])
    prev = jnp.stack([c[1] for c in cases])
    masks = cases[0][2]
    a, c = _coeffs(3)
    keep = _keep(masks, 3, masked)
    got = jax.vmap(lambda fi, pi: rs.rbgs_sweep(3, fi, pi, keep, a, c,
                                                interpret=True))(f, prev)
    for i in range(2):
        want = linear_solver(3, f[i], prev[i], a, c, masks, acc=1,
                             empty_scene=not masked)
        np.testing.assert_array_equal(np.asarray(got[i]), np.asarray(want))


def _has_pallas_call(fn, *args):
    return "pallas_call" in str(jax.make_jaxpr(fn)(*args))


@pytest.mark.parametrize("backend,use_pallas,solver,expect_kernel", [
    ("gpu", True, "rbgs", True),
    ("gpu", False, "rbgs", False),
    ("gpu", True, "jacobi", False),
    ("gpu", True, "gs_wavefront", False),
    ("cpu", True, "rbgs", False),
    ("cpu", False, "rbgs", False),
])
def test_linear_solver_kernel_choice(monkeypatch, backend, use_pallas,
                                     solver, expect_kernel):
    """The kernel runs exactly for rbgs with use_pallas on the GPU; the
    other solvers and the CPU run the jnp sweeps."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    f, prev, masks = _case(True, jnp.float32)
    fn = lambda f, p: linear_solver(1, f, p, 0.5, 4.0, masks, acc=2,
                                    solver=solver, use_pallas=use_pallas)
    assert _has_pallas_call(fn, f, prev) is expect_kernel


@pytest.mark.parametrize("shape", [(2, 9, 15), (1291, 1291, 1291)])
def test_sweep_rejects_unsupported_shapes(shape):
    """No interior, or more cells than int32 indexing reaches: a clear
    error at trace time, never a silent fallback."""
    x = jax.ShapeDtypeStruct(shape, jnp.float32)
    with pytest.raises(ValueError):
        jax.eval_shape(lambda f, p: rs.rbgs_sweep(0, f, p, None, 1.0, 6.0),
                       x, x)


@pytest.mark.gpu
def test_compiled_sweep_matches_jnp_on_gpu(gpu):
    """The kernel as compiled for the card, against the jnp sweep (chip_smoke
    runs the same comparison at full size)."""
    for masked in (False, True):
        f, prev, masks = _case(masked, jnp.float32)
        a, c = _coeffs(1)
        want = linear_solver(1, f, prev, a, c, masks, acc=15,
                             empty_scene=not masked)
        got = linear_solver(1, f, prev, a, c, masks, acc=15, use_pallas=True,
                            empty_scene=not masked)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=0, atol=1e-5 * float(
                                       np.abs(np.asarray(want)).max()))
