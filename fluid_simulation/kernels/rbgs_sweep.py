"""One red-black Gauss-Seidel sweep plus setBounds in one GPU launch.

The jnp sweep (``ops/linsolve.py``) is a red half-sweep, a black half-sweep,
six face writes and a keep multiply: several passes over the padded field.
This kernel (Pallas through Triton) reads ``f``, ``prev`` and ``keep`` once
and writes ``f`` once.

Layout: the padded field is flattened. Program ``(i, j)`` covers planes
``j*bz .. j*bz+bz-1`` and flat in-plane positions ``i*bp .. i*bp+bp-1``, so x
is contiguous and power-of-two blocks cover every grid shape. Lanes past the
end of the field are clamped onto its last plane and position: they recompute
and store that cell's own value, so no store needs a mask.

Per cell, with ``src`` the cell clamped into the interior:

- a red cell's new value is ``(prev + a*sum6(f)) * (1/c)`` over the old field;
- a black cell's six neighbours are red or ghost cells, so the kernel
  recomputes each red neighbour's update from the old field (ghost
  neighbours keep their old values) — no exchange inside the launch;
- a face cell takes the new value of its interior neighbour with the face's
  sign (``ops.bounds.face_signs``), edges and corners keep their old values,
  and every cell is then multiplied by ``keep``.

The arithmetic keeps the jnp sweep's operand order, so in interpret mode the
result is bitwise equal to it for float32.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from fluid_simulation.ops.bounds import face_signs

# Launch shape: (planes per program, in-plane cells per program), warps and
# pipeline stages. Chosen by timing on an H100 (see CHANGES.md).
BLOCK = (4, 128)
NUM_WARPS = 4
NUM_STAGES = 1


def _kernel(*refs, shape, a, c_recip, signs, masked, bz, bp):
    if masked:
        f_ref, prev_ref, keep_ref, o_ref = refs
    else:
        f_ref, prev_ref, o_ref = refs
    D2, H2, W2 = shape
    HW = H2 * W2
    N = D2 * HW
    dtype = o_ref.dtype
    av = jnp.asarray(a, dtype)
    cr = jnp.asarray(c_recip, dtype)

    z = jnp.minimum(pl.program_id(1) * bz
                    + jnp.arange(bz, dtype=jnp.int32)[:, None], D2 - 1)
    p = jnp.minimum(pl.program_id(0) * bp
                    + jnp.arange(bp, dtype=jnp.int32)[None, :], HW - 1)
    y = lax.div(p, jnp.int32(W2))
    x = p - y * W2
    zs = jnp.clip(z, 1, D2 - 2)
    ys = jnp.clip(y, 1, H2 - 2)
    xs = jnp.clip(x, 1, W2 - 2)
    src = zs * HW + ys * W2 + xs
    cell = z * HW + p

    loaded = {}

    def load(ref, off, dz):
        """``ref`` at ``src + off``; only the two-plane z reach can leave
        the array, and only for values the selects below discard."""
        key = (id(ref), off)
        if key not in loaded:
            idx = src + off
            if abs(dz) == 2:
                idx = jnp.clip(idx, 0, N - 1)
            loaded[key] = plgpu.load(ref.at[idx])
        return loaded[key]

    # the six neighbours in the reference's summation order
    # (simulation.cpp:266-268): x+, x-, y+, y-, z+, z-
    nbrs = ((1, 0), (-1, 0), (W2, 0), (-W2, 0), (HW, 1), (-HW, -1))

    def red(off, dz):
        """The red half-sweep's update at ``src + off`` (old field)."""
        s = None
        for o2, d2 in nbrs:
            v = load(f_ref, off + o2, dz + d2)
            s = v if s is None else s + v
        return (load(prev_ref, off, dz) + av * s) * cr

    inside = (xs < W2 - 2, xs > 1, ys < H2 - 2, ys > 1, zs < D2 - 2, zs > 1)
    s = None
    for (off, dz), ok in zip(nbrs, inside):
        v = jnp.where(ok, red(off, dz), load(f_ref, off, dz))
        s = v if s is None else s + v
    black = (load(prev_ref, 0, 0) + av * s) * cr
    is_red = lax.rem(zs + ys + xs, 2) == 0
    val = jnp.where(is_red, red(0, 0), black)

    ix = (x >= 1) & (x <= W2 - 2)
    iy = (y >= 1) & (y <= H2 - 2)
    iz = (z >= 1) & (z <= D2 - 2)
    interior = ix & iy & iz
    face = (ix & iy) | (ix & iz) | (iy & iz)
    face = face & ~interior
    sx, sy, sz = signs
    neg = [m for m, sgn in ((x == 0, sx), (~iy, sy), (~iz, sz)) if sgn < 0]
    face_val = val
    if neg:
        flip = functools.reduce(lambda u, v: u | v, neg)
        face_val = jnp.where(flip, -val, val)
    old = plgpu.load(f_ref.at[cell], mask=~(interior | face), other=0.0)
    out = jnp.where(interior, val, jnp.where(face, face_val, old))
    if masked:
        out = out * plgpu.load(keep_ref.at[cell])
    plgpu.store(o_ref.at[cell], out.astype(dtype))


def rbgs_sweep(b: int, f, prev, keep, a: float, c: float,
               wall_mode: str = "reference", *, block=None,
               num_warps=None, num_stages=None, interpret: bool = False):
    """One red-black sweep of ``f = (prev + a*sum6(f))/c`` followed by
    ``set_bounds(b, ...)`` on a padded (D+2, H+2, W+2) field — the same
    update as one iteration of the jnp rbgs loop in
    ``ops.linsolve.linear_solver``. ``keep`` is the padded keep mask, or
    None for a scene without solids. The launch shape defaults to the
    module's ``BLOCK``, ``NUM_WARPS`` and ``NUM_STAGES``."""
    shape = tuple(f.shape)
    D2, H2, W2 = shape
    if min(shape) < 3:
        raise ValueError(f"padded shape {shape} has no interior")
    if f.size + 2 * H2 * W2 >= 2 ** 31:   # the z+2 reach must fit int32
        raise ValueError(f"field of {f.size} cells exceeds int32 indexing")
    bz, bp = block or BLOCK
    kernel = functools.partial(
        _kernel, shape=shape, a=float(a),
        c_recip=float(np.float32(1.0) / np.float32(c)),
        signs=face_signs(b, wall_mode), masked=keep is not None,
        bz=bz, bp=bp)
    operands = [f.reshape(-1), prev.reshape(-1)]
    if keep is not None:
        operands.append(keep.astype(f.dtype).reshape(-1))
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((f.size,), f.dtype),
        grid=(pl.cdiv(H2 * W2, bp), pl.cdiv(D2, bz)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=num_warps or NUM_WARPS,
            num_stages=num_stages or NUM_STAGES),
        interpret=interpret,
        name="rbgs_sweep",
    )(*operands)
    return out.reshape(shape)
