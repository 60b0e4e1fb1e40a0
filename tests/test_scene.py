"""Scene layer: STL parsing, rotation semantics, both voxelizers, and the
compat voxelizer's statistical parity with the reference binary's output."""

import os
import struct

import numpy as np
import pytest

from fluid_simulation.config import SceneParams
from fluid_simulation.scene.stl import (
    read_stl, rotation_matrix, rotate_triangles)
from fluid_simulation.scene.voxelize import (
    grid_mapping, load_stl_into_obstacles, voxelize_rasterize,
    voxelize_ray_parity)
from fluid_simulation.scene.primitives import empty_obstacles, add_sphere

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _write_binary_stl(path, tris):
    with open(path, "wb") as f:
        f.write(b"\0" * 80)
        f.write(struct.pack("<I", len(tris)))
        for t in tris:
            f.write(struct.pack("<3f", 0, 0, 1))
            for v in t:
                f.write(struct.pack("<3f", *v))
            f.write(struct.pack("<H", 0))


def _write_ascii_stl(path, tris):
    with open(path, "w") as f:
        f.write("solid test\n")
        for t in tris:
            f.write(" facet normal 0 0 1\n  outer loop\n")
            for v in t:
                f.write(f"   vertex {v[0]} {v[1]} {v[2]}\n")
            f.write("  endloop\n endfacet\n")
        f.write("endsolid test\n")


def _cube_tris(lo=-1.0, hi=1.0):
    """12 triangles of an axis-aligned cube."""
    c = np.array([[x, y, z] for x in (lo, hi) for y in (lo, hi)
                  for z in (lo, hi)])
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
             (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    tris = []
    for a, b, cc, d in quads:
        tris.append([c[a], c[b], c[cc]])
        tris.append([c[a], c[cc], c[d]])
    return np.asarray(tris, dtype=np.float32)


def test_read_stl_binary_and_ascii(tmp_path):
    tris = _cube_tris()
    pb = str(tmp_path / "cube_bin.stl")
    pa = str(tmp_path / "cube_ascii.stl")
    _write_binary_stl(pb, tris)
    _write_ascii_stl(pa, tris)
    tb = read_stl(pb)
    ta = read_stl(pa)
    assert tb.shape == (12, 3, 3) and ta.shape == (12, 3, 3)
    np.testing.assert_allclose(tb, tris, atol=1e-6)
    np.testing.assert_allclose(np.sort(ta.reshape(-1)), np.sort(tris.reshape(-1)),
                               atol=1e-5)


def test_read_stl_missing():
    with pytest.raises(FileNotFoundError):
        read_stl("/no/such/file.stl")


def test_rotation_matrix_composition():
    # 90 deg about x maps (0,1,0)->(0,0,1): R = Rx (object_loader.cpp:182-199)
    R = rotation_matrix(90, 0, 0)
    np.testing.assert_allclose(R @ [0, 1, 0], [0, 0, 1], atol=1e-6)
    # R = Rx*Ry*Rz applies Rz first
    R2 = rotation_matrix(90, 0, 90)
    np.testing.assert_allclose(R2 @ [1, 0, 0], [0, 0, 1], atol=1e-6)


def test_rotation_center_modes():
    tris = _cube_tris(lo=2.0, hi=4.0)  # off-origin cube
    rot_o, c_o = rotate_triangles(tris, 0, 0, 90, center="origin")
    rot_b, c_b = rotate_triangles(tris, 0, 0, 90, center="bbox_center")
    np.testing.assert_array_equal(c_o, [0, 0, 0])
    np.testing.assert_allclose(c_b, [3, 3, 3], atol=1e-5)
    # origin mode swings the cube to x in [-4,-2] (reference quirk);
    # bbox mode keeps it in place
    assert rot_o.reshape(-1, 3)[:, 0].min() < -1.9
    np.testing.assert_allclose(sorted(np.unique(np.round(rot_b.reshape(-1, 3)[:, 0], 3))),
                               [2, 4], atol=1e-5)


def test_voxelize_rasterize_cube_exact():
    # cube in grid space covering cells x,y,z in [4..7] exactly
    tris = _cube_tris(lo=4.0, hi=8.0)
    obs = voxelize_rasterize(tris.astype(np.float64), 12, 12, 12)
    expected = np.zeros_like(obs)
    expected[4:8, 4:8, 4:8] = 1.0
    np.testing.assert_array_equal(obs, expected)


def test_voxelizers_agree_on_sphere(tmp_path):
    # both engines on the same sphere mesh -> high IoU with the analytic ball
    from tools.make_goldens import make_icosphere_stl
    stl = str(tmp_path / "sphere.stl")
    make_icosphere_stl(stl, radius=10.0, subdiv=2)
    scene = SceneParams(stl_path=stl, scale=0.8, voxelizer="rasterize")
    W, H, D = 32, 32, 32
    obs_r = load_stl_into_obstacles(scene, empty_obstacles(W, H, D))
    # analytic: gridScale = 0.8*32/objSize maps the ball to radius ~12.2 ...
    # compare against add_sphere with the same mapping instead of hardcoding
    from fluid_simulation.scene.stl import bounding_sphere_box
    tris = read_stl(stl)
    lo, hi, r = bounding_sphere_box(tris, np.zeros(3, np.float32))
    to_grid, gscale = grid_mapping(lo, hi, np.zeros(3, np.float32), 0.8,
                                   W, H, D, (0, 0, 0))
    center = to_grid(np.zeros((1, 3)))[0]
    # cell (x,y,z) covers [x,x+1): its center in grid coords is x+0.5
    analytic = add_sphere(empty_obstacles(W, H, D),
                          center[0] - 0.5, center[1] - 0.5, center[2] - 0.5,
                          r * gscale)
    inter = np.logical_and(obs_r > 0, analytic > 0).sum()
    union = np.logical_or(obs_r > 0, analytic > 0).sum()
    assert inter / union > 0.85

    scene2 = SceneParams(stl_path=stl, scale=0.8, voxelizer="ray_parity")
    # native engine when buildable (bit-identical to NumPy per test_native;
    # the NumPy full-rule path costs ~6 min here) — falls back automatically
    obs_p = load_stl_into_obstacles(scene2, empty_obstacles(W, H, D))
    # ray-parity keeps the reference's shell quirk, and marks any cell that
    # contains an inside sample point (outer-inclusive): every shell cell must
    # lie within one cell of the rasterized solid
    solid = obs_r > 0
    dilated = solid.copy()
    for ax in range(3):
        dilated |= np.roll(solid, 1, ax) | np.roll(solid, -1, ax)
    assert (obs_p[dilated].sum()) / max(obs_p.sum(), 1) > 0.98
    assert 0.2 * obs_r.sum() < obs_p.sum() <= obs_r.sum()


def test_ray_parity_matches_reference_golden():
    path = os.path.join(GOLDEN_DIR, "sphere_voxels_64x32x32.npz")
    if not os.path.exists(path):
        pytest.skip("golden missing — run tools/make_goldens.py")
    g = np.load(path)
    from tools.make_goldens import make_icosphere_stl
    import tempfile
    with tempfile.TemporaryDirectory() as td:
        stl = os.path.join(td, "s.stl")
        make_icosphere_stl(stl, radius=float(g["radius"]),
                           subdiv=int(g["subdiv"]))
        rot = g["rot"]; tr = g["translate"]
        scene = SceneParams(stl_path=stl, scale=float(g["scale"]),
                            rot_x=float(rot[0]), rot_y=float(rot[1]),
                            rot_z=float(rot[2]), translate_x=float(tr[0]),
                            translate_y=float(tr[1]), translate_z=float(tr[2]),
                            voxelizer="ray_parity")
        obs = load_stl_into_obstacles(scene, empty_obstacles(64, 32, 32))
    ref = g["obs"]
    inter = np.logical_and(obs > 0, ref > 0).sum()
    union = np.logical_or(obs > 0, ref > 0).sum()
    # the reference jitters points and rays randomly (object_loader.cpp:
    # 396-423), so parity is statistical: same shell, tiny boundary noise
    assert inter / union > 0.9


def test_load_stl_graceful_failure():
    obs = empty_obstacles(8, 8, 8)
    scene = SceneParams(stl_path="/absent/file.stl")
    out = load_stl_into_obstacles(scene, obs)
    np.testing.assert_array_equal(out, obs)    # object_loader.cpp:282-285
