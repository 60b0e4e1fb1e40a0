"""Operator-split advection (ops/advect.py::advect_split_jnp) against the
NumPy oracle, and model-level 'split' mode sanity."""

import itertools

import numpy as np
import jax.numpy as jnp
import pytest

import numpy_ref
from fluid_simulation.config import SimParams
from fluid_simulation.models.windtunnel import WindTunnel
from fluid_simulation.ops.advect import advect_split_jnp


def _fields(W=24, H=12, D=10, seed=0):
    rng = np.random.default_rng(seed)
    shape = (D + 2, H + 2, W + 2)
    prev = rng.normal(size=shape).astype(np.float32)
    vx = rng.uniform(-20, 25, size=shape).astype(np.float32)
    vy = rng.uniform(-3, 3, size=shape).astype(np.float32)
    vz = rng.uniform(-3, 3, size=shape).astype(np.float32)
    return (jnp.asarray(prev), jnp.asarray(vx), jnp.asarray(vy),
            jnp.asarray(vz))


def test_advect_split_jnp_matches_reference():
    prev, vx, vy, vz = _fields(seed=3)
    want = numpy_ref.advect_split(prev, vx, vy, vz, 0.05)
    got = np.asarray(advect_split_jnp(prev, vx, vy, vz, 0.05))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "dims,stacked,dtype",
    list(itertools.product(((24, 12, 10), (9, 5, 7), (130, 6, 4)),
                           (False, True), ("float32", "bfloat16"))))
def test_advect_split_matches_oracle(dims, stacked, dtype):
    """Odd and wide axes, one field or a stack of three advected through
    the same velocity, f32 and bf16 fields (coordinates stay f32)."""
    W, H, D = dims
    prev, vx, vy, vz = _fields(W, H, D, seed=sum(dims))
    dt = jnp.dtype(dtype)
    fields = [prev, prev * 0.5 + 0.1, prev * -0.25] if stacked else [prev]
    fields = [f.astype(dt) for f in fields]
    arg = jnp.stack(fields) if stacked else fields[0]
    got = np.asarray(advect_split_jnp(arg, vx, vy, vz, 0.05), np.float32)
    assert got.shape == ((3,) if stacked else ()) + (D, H, W)
    got = got if stacked else got[None]
    tol = 1e-5 if dtype == "float32" else 3e-2
    for g, f in zip(got, fields):
        want = numpy_ref.advect_split(np.asarray(f, np.float32), vx, vy, vz,
                                      0.05)
        np.testing.assert_allclose(g, want, rtol=tol, atol=tol)


def test_split_mode_model_tracks_compat():
    p = SimParams(width=16, height=8, depth=8, acc=6)
    wt_c = WindTunnel(p)
    wt_s = WindTunnel(p.replace(mode="split"))
    _, sc = wt_c.simulate(steps=5)
    _, ss = wt_s.simulate(steps=5)
    a = np.asarray(sc.density_sum)
    b = np.asarray(ss.density_sum)
    assert np.all(np.isfinite(b)) and np.all(np.diff(b) > 0)
    assert 0.4 < b[-1] / a[-1] < 2.5
    for f in wt_s.state:
        assert np.all(np.isfinite(np.asarray(f)))
    # solid-cell invariant holds in split mode too
    from fluid_simulation.scene.primitives import empty_obstacles, add_sphere
    obs = add_sphere(empty_obstacles(16, 8, 8), 8, 4, 4, 2.5)
    wt_o = WindTunnel(p.replace(mode="split"), obstacles=obs)
    wt_o.simulate(steps=4)
    solid = np.asarray(obs) >= 0.5
    for f in wt_o.state:
        assert np.all(np.asarray(f)[solid] == 0.0)


def test_split_mode_bfloat16_runs():
    p = SimParams(width=16, height=8, depth=8, acc=4, mode="split",
                  dtype="bfloat16")
    wt = WindTunnel(p)
    _, stats = wt.simulate(steps=3)
    assert np.all(np.isfinite(np.asarray(stats.density_sum)))
