"""NumPy oracles for the solver operators, written independently of ops/.

Each follows the reference's loops (simulation.cpp, cited per function) in
float32 with the same operand order as the jnp operators, so the tests can
compare at ulp level.
"""

import numpy as np

F32 = np.float32


def face_signs(b, wall_mode):
    """setBounds' mirror signs on the x-, y-, z-faces (simulation.cpp:189-215);
    'noslip' negates every velocity component on the y/z walls."""
    sx = -1.0 if b == 1 else 1.0
    if wall_mode == "noslip" and b in (1, 2, 3):
        return sx, -1.0, -1.0
    return sx, (-1.0 if b == 2 else 1.0), (-1.0 if b == 3 else 1.0)


def keep_masks(obstacles):
    """(keep_scalar, keep_vel) padded multipliers: zero in solids, and for
    velocity also on fluid cells 6-adjacent to a solid (simulation.cpp:218-245);
    one on the ghost shell."""
    solid = (np.asarray(obstacles) >= 0.5)
    s = solid[1:-1, 1:-1, 1:-1]
    adj = (solid[1:-1, 1:-1, 2:] | solid[1:-1, 1:-1, :-2]
           | solid[1:-1, 2:, 1:-1] | solid[1:-1, :-2, 1:-1]
           | solid[2:, 1:-1, 1:-1] | solid[:-2, 1:-1, 1:-1]) & ~s
    ks = np.ones(solid.shape, F32)
    ks[1:-1, 1:-1, 1:-1] = ~s
    kv = ks.copy()
    kv[1:-1, 1:-1, 1:-1] = ~s & ~adj
    return ks, kv


def set_bounds(b, f, keep=None, wall_mode="reference"):
    """simulation.cpp:183-246: signed face mirrors (x+ is an outflow copy),
    ghost edges untouched, then the obstacle multiplier."""
    f = np.array(f, F32)
    sx, sy, sz = (F32(v) for v in face_signs(b, wall_mode))
    f[1:-1, 1:-1, 0] = sx * f[1:-1, 1:-1, 1]
    f[1:-1, 1:-1, -1] = f[1:-1, 1:-1, -2]
    f[1:-1, 0, 1:-1] = sy * f[1:-1, 1, 1:-1]
    f[1:-1, -1, 1:-1] = sy * f[1:-1, -2, 1:-1]
    f[0, 1:-1, 1:-1] = sz * f[1, 1:-1, 1:-1]
    f[-1, 1:-1, 1:-1] = sz * f[-2, 1:-1, 1:-1]
    return f if keep is None else f * keep


def _nsum(f):
    """Six-neighbour sum in the reference's order (simulation.cpp:266-268)."""
    return ((((f[1:-1, 1:-1, 2:] + f[1:-1, 1:-1, :-2]) + f[1:-1, 2:, 1:-1])
             + f[1:-1, :-2, 1:-1]) + f[2:, 1:-1, 1:-1]) + f[:-2, 1:-1, 1:-1]


def _red(shape):
    D2, H2, W2 = shape
    z, y, x = np.meshgrid(np.arange(1, D2 - 1), np.arange(1, H2 - 1),
                          np.arange(1, W2 - 1), indexing="ij")
    return (z + y + x) % 2 == 0


def _seq_gs_sweep(f, prev, a, crec):
    """Sequential lexicographic Gauss-Seidel, the reference's loop nest
    (x outermost, simulation.cpp:258-270)."""
    f = f.copy()
    D2, H2, W2 = f.shape
    for i in range(1, W2 - 1):
        for j in range(1, H2 - 1):
            for k in range(1, D2 - 1):
                s = F32(((((f[k, j, i + 1] + f[k, j, i - 1]) + f[k, j + 1, i])
                          + f[k, j - 1, i]) + f[k + 1, j, i]) + f[k - 1, j, i])
                f[k, j, i] = F32(prev[k, j, i] + a * s) * crec
    return f


def solve(solver, b, f, prev, a, c, keep=None, wall_mode="reference",
          acc=15):
    """``acc`` sweeps of ``f = (prev + a*sum6(f))/c``, setBounds after each
    (simulation.cpp:251-273), in the named ordering."""
    f = np.array(f, F32)
    prev = np.asarray(prev, F32)
    a, crec = F32(a), F32(1.0) / F32(c)
    prev_i = prev[1:-1, 1:-1, 1:-1]
    red = _red(f.shape)
    for _ in range(acc):
        if solver == "jacobi":
            f[1:-1, 1:-1, 1:-1] = (prev_i + a * _nsum(f)) * crec
        elif solver == "rbgs":
            upd = (prev_i + a * _nsum(f)) * crec
            f[1:-1, 1:-1, 1:-1] = np.where(red, upd, f[1:-1, 1:-1, 1:-1])
            upd = (prev_i + a * _nsum(f)) * crec
            f[1:-1, 1:-1, 1:-1] = np.where(red, f[1:-1, 1:-1, 1:-1], upd)
        elif solver == "gs_wavefront":
            f = _seq_gs_sweep(f, prev, a, crec)
        else:
            raise ValueError(solver)
        f = set_bounds(b, f, keep, wall_mode)
    return f


def _neighbour_fluid(obstacles):
    """(xp, xm, yp, ym, zp, zm): the neighbour is an interior fluid cell
    (simulation.cpp:297-316 and :329-355 guards)."""
    fl = (np.asarray(obstacles) < 0.5).astype(F32)
    inb = np.zeros_like(fl)
    inb[1:-1, 1:-1, 1:-1] = 1
    fl = fl * inb
    return (fl[1:-1, 1:-1, 2:], fl[1:-1, 1:-1, :-2], fl[1:-1, 2:, 1:-1],
            fl[1:-1, :-2, 1:-1], fl[2:, 1:-1, 1:-1], fl[:-2, 1:-1, 1:-1])


def project(vx, vy, vz, obstacles, wall_mode="reference", acc=15):
    """Simulation::project (simulation.cpp:289-362) with red-black sweeps:
    obstacle-aware divergence, Poisson solve, central/one-sided gradient."""
    vx, vy, vz = (np.array(v, F32) for v in (vx, vy, vz))
    D2, H2, W2 = vx.shape
    h = F32(1.0) / np.cbrt(F32((W2 - 2) * (H2 - 2) * (D2 - 2)))
    ks, kv = keep_masks(obstacles)
    fluid = (np.asarray(obstacles) < 0.5)[1:-1, 1:-1, 1:-1].astype(F32)
    xp, xm, yp, ym, zp, zm = _neighbour_fluid(obstacles)
    div = np.zeros_like(vx)
    div[1:-1, 1:-1, 1:-1] = (F32(-0.5) * h) * (
        vx[1:-1, 1:-1, 2:] * xp - vx[1:-1, 1:-1, :-2] * xm
        + vy[1:-1, 2:, 1:-1] * yp - vy[1:-1, :-2, 1:-1] * ym
        + vz[2:, 1:-1, 1:-1] * zp - vz[:-2, 1:-1, 1:-1] * zm) * fluid
    div = set_bounds(0, div, ks, wall_mode)
    p = solve("rbgs", 0, np.zeros_like(vx), div, 1.0, 6.0, ks, wall_mode,
              acc)
    inv_h, inv_2h = F32(1.0) / h, F32(1.0) / (F32(2.0) * h)
    pi = p[1:-1, 1:-1, 1:-1]

    def grad(pp, pm, mp, mm):
        both = mp * mm
        return (both * ((pp - pm) * inv_2h) + (mp - both) * ((pp - pi) * inv_h)
                + (mm - both) * ((pi - pm) * inv_h))

    gx = grad(p[1:-1, 1:-1, 2:], p[1:-1, 1:-1, :-2], xp, xm)
    gy = grad(p[1:-1, 2:, 1:-1], p[1:-1, :-2, 1:-1], yp, ym)
    gz = grad(p[2:, 1:-1, 1:-1], p[:-2, 1:-1, 1:-1], zp, zm)
    vx[1:-1, 1:-1, 1:-1] += -gx * fluid
    vy[1:-1, 1:-1, 1:-1] += -gy * fluid
    vz[1:-1, 1:-1, 1:-1] += -gz * fluid
    return (set_bounds(1, vx, kv, wall_mode), set_bounds(2, vy, kv, wall_mode),
            set_bounds(3, vz, kv, wall_mode))


def confinement(vx, vy, vz, obstacles, eps, dt):
    """Vorticity confinement (Fedkiw, Stam & Jensen 2001): curl by central
    differences, N = grad|w| / |grad|w||, v += eps*dt*keep_vel*(N x w)."""
    vx, vy, vz = (np.array(v, F32) for v in (vx, vy, vz))

    def c(f, axis):
        if axis == 0:
            return F32(0.5) * (f[2:, 1:-1, 1:-1] - f[:-2, 1:-1, 1:-1])
        if axis == 1:
            return F32(0.5) * (f[1:-1, 2:, 1:-1] - f[1:-1, :-2, 1:-1])
        return F32(0.5) * (f[1:-1, 1:-1, 2:] - f[1:-1, 1:-1, :-2])

    wx = c(vz, 1) - c(vy, 0)
    wy = c(vx, 0) - c(vz, 2)
    wz = c(vy, 2) - c(vx, 1)
    mag = np.zeros_like(vx)
    mag[1:-1, 1:-1, 1:-1] = np.sqrt(wx * wx + wy * wy + wz * wz)
    gx, gy, gz = c(mag, 2), c(mag, 1), c(mag, 0)
    norm = np.sqrt(gx * gx + gy * gy + gz * gz) + F32(1e-5)
    nx, ny, nz = gx / norm, gy / norm, gz / norm
    _, kv = keep_masks(obstacles)
    s = F32(eps) * F32(dt) * kv[1:-1, 1:-1, 1:-1]
    vx[1:-1, 1:-1, 1:-1] += s * (ny * wz - nz * wy)
    vy[1:-1, 1:-1, 1:-1] += s * (nz * wx - nx * wz)
    vz[1:-1, 1:-1, 1:-1] += s * (nx * wy - ny * wx)
    return vx, vy, vz


def advect_split(prev, vx, vy, vz, dt):
    """Operator-split advection: lerp along x, then y, then z, each axis
    backtraced by dt*N*v at the output cell and clamped to [0.5, N+0.5]
    (simulation.cpp:384-390). Returns the advected interior."""
    prev = np.asarray(prev, F32)
    vx, vy, vz = (np.asarray(v, F32) for v in (vx, vy, vz))
    D2, H2, W2 = prev.shape
    D, H, W = D2 - 2, H2 - 2, W2 - 2
    dt = F32(dt)

    def lerp(arr, coords, axis):
        i0 = np.floor(coords).astype(np.int64)
        s = (coords - i0).astype(F32)
        a = np.take_along_axis(arr, i0, axis=axis)
        b = np.take_along_axis(arr, i0 + 1, axis=axis)
        return a * (1 - s) + b * s

    xi = np.arange(1, W + 1, dtype=F32)
    xb = np.clip(xi[None, None, :] - dt * F32(W) * vx[:, :, 1:-1], 0.5,
                 W + 0.5)
    A = lerp(prev, xb, axis=2)                            # (D2, H2, W)
    yi = np.arange(1, H + 1, dtype=F32)
    yb = np.clip(yi[None, :, None] - dt * F32(H) * vy[:, 1:-1, 1:-1], 0.5,
                 H + 0.5)
    B = lerp(A, yb, axis=1)                               # (D2, H, W)
    zi = np.arange(1, D + 1, dtype=F32)
    zb = np.clip(zi[:, None, None] - dt * F32(D) * vz[1:-1, 1:-1, 1:-1], 0.5,
                 D + 0.5)
    return lerp(B, zb, axis=0)                            # (D, H, W)
