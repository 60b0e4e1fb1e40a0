"""Native C++ runtime pieces vs their NumPy twins.

Skipped wholesale when the toolchain can't produce libfstpu.so (every
consumer falls back to NumPy in that case).
"""

import os

import numpy as np
import pytest

try:
    from fluid_simulation.native import load_library
    load_library()
    HAVE_NATIVE = True
except OSError:
    HAVE_NATIVE = False

pytestmark = pytest.mark.skipif(not HAVE_NATIVE,
                                reason="native library unavailable")


def _cube_stl(tmp_path, lo=-2.0, hi=2.0):
    import struct
    c = np.array([[x, y, z] for x in (lo, hi) for y in (lo, hi)
                  for z in (lo, hi)], dtype=np.float32)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
             (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    tris = []
    for a, b, cc, d in quads:
        tris += [[c[a], c[b], c[cc]], [c[a], c[cc], c[d]]]
    path = str(tmp_path / "cube.stl")
    with open(path, "wb") as f:
        f.write(b"\0" * 80)
        f.write(struct.pack("<I", len(tris)))
        for t in tris:
            f.write(struct.pack("<3f", 0, 0, 1))
            for v in t:
                f.write(struct.pack("<3f", *v))
            f.write(struct.pack("<H", 0))
    return path


def _voxelize_both(tmp_path, stl_path, rot_angles=(15, 25, 35)):
    from fluid_simulation.native import geometry as ngeo
    from fluid_simulation.scene.stl import (
        read_stl, rotate_triangles, bounding_sphere_box)
    from fluid_simulation.scene.voxelize import voxelize_ray_parity
    tris = read_stl(stl_path)
    rot, center = rotate_triangles(tris, *rot_angles)
    lo, hi, _ = bounding_sphere_box(tris, center)
    args = (rot, center, lo, hi, 0.6, 24, 16, 16, (1.0, 0.0, -1.0))
    # fine_divisor=48 (reference rule is 200): same code path in both
    # engines, ~70x fewer fine points — this test asserts ENGINE EQUALITY,
    # not absolute resolution (full-rule runs live in test_scene via the
    # native engine, and the golden IoU check)
    kw = dict(seed=11, fine_divisor=48.0)
    return (voxelize_ray_parity(*args, **kw),
            ngeo.voxelize_ray_parity(*args, **kw))


def test_native_voxelizer_bit_identical_generic_mesh(tmp_path):
    # generic (non-axis-degenerate) mesh: identical down to the last cell
    from tools.make_goldens import make_icosphere_stl
    stl = str(tmp_path / "ico.stl")
    make_icosphere_stl(stl, radius=4.0, subdiv=0)
    m_np, m_cc = _voxelize_both(tmp_path, stl)
    assert m_np.sum() > 0
    np.testing.assert_array_equal(m_np, m_cc)


def test_native_voxelizer_cube_edge_seams(tmp_path):
    # a cube's face seams graze rays exactly; Moller-Trumbore borderline
    # verdicts may flip O(1) cells between the two implementations
    m_np, m_cc = _voxelize_both(tmp_path, _cube_stl(tmp_path))
    assert m_np.sum() > 100
    assert np.abs(m_np - m_cc).sum() <= 3


def test_native_framewriter_roundtrip(tmp_path):
    from fluid_simulation.native.framewriter import NativeFrameWriter
    paths = [str(tmp_path / f"f{i}.bin") for i in range(3)]
    rng = np.random.default_rng(0)
    frames = [[rng.normal(size=(4, 5)).astype(np.float32) for _ in range(3)]
              for _ in range(5)]
    w = NativeFrameWriter(paths)
    for fr in frames:
        w.append(fr)
    # skip-file support: None skips
    w.append([frames[0][0], None, frames[0][2]])
    w.close()

    for i, p in enumerate(paths):
        data = np.fromfile(p, dtype=np.float32)
        want = [fr[i].ravel() for fr in frames]
        if i != 1:
            want.append(frames[0][i].ravel())
        np.testing.assert_array_equal(data, np.concatenate(want))


def test_io_dump_native_backend(tmp_path):
    from fluid_simulation.config import SimParams
    from fluid_simulation.io.dump import FrameWriter, read_run, FIELD_FILES
    p = SimParams(width=8, height=4, depth=4)
    d = str(tmp_path / "data")
    rng = np.random.default_rng(1)
    frame = {k: rng.normal(size=p.padded_shape).astype(np.float32)
             for k, _ in FIELD_FILES}
    with FrameWriter(d, p, backend="native") as w:
        assert w._native is not None  # really took the native path
        w.append(frame)
    run = read_run(d)
    np.testing.assert_array_equal(run["vx"][0], frame["vx"])
