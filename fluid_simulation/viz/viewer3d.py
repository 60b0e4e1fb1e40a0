"""3-D viewer: obstacle iso-surface + streamlines.

Parity targets: the viewer app (GUI/main.py:11-41 — data existence checks),
window + controls (GUI/main_window.py:14-243 — obstacle/streamline toggles,
proximity/density/length sliders, FPS + render-time labels, last-frame-only
loading) and the GL render widget (GUI/gl_widget.py:13-379 — mesh fill +
wireframe, line-strip streamlines with a 100k-point cap, orbit/pan/zoom).

``build_scene`` is the headless core (tested without any GUI): it loads the
last frame, transposes (z,y,x) -> (x,y,z) like GUI/main_window.py:204,227-231,
extracts the mesh (in-house marching tetrahedra), integrates streamlines, and
applies the viewer's origin shift of -1 (GUI/main_window.py:224,243).

Backends: PyQt6+PyOpenGL when importable; otherwise a matplotlib 3-D fallback
so the scene is viewable anywhere.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from fluid_simulation.config import ViewerParams
from fluid_simulation.io.dump import FIELD_FILES, read_last_frame
from fluid_simulation.viz.marching import generate_obstacle_mesh
from fluid_simulation.viz.streamlines import generate_streamlines

MAX_STREAMLINE_POINTS = 100_000  # gl_widget.py:252-276 safety cap


def check_data_dir(data_dir: str) -> Optional[str]:
    """The startup existence checks (GUI/main.py:13-25); returns an error
    message or None when everything is present."""
    if not os.path.isdir(data_dir):
        return (f"Error: Data directory '{data_dir}' not found.\n"
                "Run the simulation first to generate the data files.")
    missing = [fn for _, fn in FIELD_FILES
               if not os.path.exists(os.path.join(data_dir, fn))]
    if missing:
        return f"Error: Missing data files: {', '.join(missing)}"
    return None


def build_scene(data_dir: str, params: ViewerParams = None,
                dims: Optional[Tuple[int, int, int]] = None,
                show_obstacles: bool = True,
                show_streamlines: bool = True) -> Dict:
    """Headless scene construction from the last dumped frame."""
    p = params or ViewerParams()
    frame = read_last_frame(data_dir, dims=dims)
    # (z, y, x) -> (x, y, z) like the viewer (GUI/main_window.py:204)
    obs = np.transpose(frame["obs"], (2, 1, 0))
    scene = {"verts": np.zeros((0, 3)), "faces": np.zeros((0, 3), np.int64),
             "streamlines": [], "colors": [],
             # padded dims in viewer axis order, like GUI/config.py:8-11
             "dims": tuple(int(n) for n in obs.shape)}
    if show_obstacles:
        mesh = generate_obstacle_mesh(obs)
        if np.size(mesh["vertexes"]):
            scene["verts"] = mesh["vertexes"] - 1.0   # origin shift (:224)
            scene["faces"] = mesh["faces"]
    if show_streamlines:
        vx = np.transpose(frame["vx"], (2, 1, 0))
        vy = np.transpose(frame["vy"], (2, 1, 0))
        vz = np.transpose(frame["vz"], (2, 1, 0))
        lines, colors = generate_streamlines(vx, vy, vz, obs, p)
        total = 0
        kept = []
        for ln in lines:
            total += len(ln)
            if total > MAX_STREAMLINE_POINTS:
                break
            kept.append(ln - 1.0)                     # origin shift (:243)
        scene["streamlines"] = kept
        scene["colors"] = colors[:len(kept)]
    return scene


def background_geometry(width: int, height: int, depth: int,
                        grid_step: int = 5, axis_len: float = 20.0) -> Dict:
    """Reference-grid / coordinate-axes / domain-bbox line sets
    (GUI/gl_widget.py:93-182), headless and testable.

    Returns ``{name: (segments(N,2,3) f32, rgba, line_width)}`` in the
    viewer's shifted frame (domain corner at (-1,-1,-1), the reference's
    ``domain_offset``). The reference's grid loops run every plane's line
    coordinate over ``range(0, width, 5)`` — lines beyond the domain on the
    shorter axes (gl_widget.py:100-121); here lines are clipped to each
    plane's true extent (a deliberate fix, same visual intent).
    """
    W, H, D = float(width), float(height), float(depth)
    o = -1.0   # domain_offset (gl_widget.py:20)
    segs = []

    def line(a, b):
        segs.append((a, b))

    # floor/back/side grids on the three coordinate planes through the origin
    for x in np.arange(0.0, W + 0.5, grid_step):
        line((x + o, o, o), (x + o, H + o, o))          # X-Y plane, x = const
        line((x + o, o, o), (x + o, o, D + o))          # X-Z plane, x = const
    for y in np.arange(0.0, H + 0.5, grid_step):
        line((o, y + o, o), (W + o, y + o, o))          # X-Y plane, y = const
        line((o, y + o, o), (o, y + o, D + o))          # Y-Z plane, y = const
    for z in np.arange(0.0, D + 0.5, grid_step):
        line((o, o, z + o), (W + o, o, z + o))          # X-Z plane, z = const
        line((o, o, z + o), (o, H + o, z + o))          # Y-Z plane, z = const
    grid = np.asarray(segs, np.float32)

    axes = {
        "axis_x": (np.asarray([[(o, o, o), (o + axis_len, o, o)]], np.float32),
                   (1.0, 0.0, 0.0, 1.0), 2.5),
        "axis_y": (np.asarray([[(o, o, o), (o, o + axis_len, o)]], np.float32),
                   (0.0, 1.0, 0.0, 1.0), 2.5),
        "axis_z": (np.asarray([[(o, o, o), (o, o, o + axis_len)]], np.float32),
                   (0.0, 0.0, 1.0, 1.0), 2.5),
    }

    # domain bounding box: 12 edges between (-1,-1,-1) and (W-1,H-1,D-1)
    # (gl_widget.py:149-182 uses config dims - 1 == padded corner positions)
    x0 = y0 = z0 = o
    x1, y1, z1 = W + o, H + o, D + o
    c = [(x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0),
         (x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1)]
    edges = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
             (0, 4), (1, 5), (2, 6), (3, 7)]
    bbox = np.asarray([[c[a], c[b]] for a, b in edges], np.float32)

    out = {"grid": (grid, (0.3, 0.3, 0.3, 0.5), 1.0),
           "bbox": (bbox, (1.0, 1.0, 1.0, 0.3), 1.5)}
    out.update(axes)
    return out


def launch_viewer_3d(data_dir: str, params: ViewerParams = None,
                     dims: Optional[Tuple[int, int, int]] = None) -> int:
    err = check_data_dir(data_dir)
    if err:
        print(err)
        return 1
    try:
        return _launch_qt_gl(data_dir, params, dims)
    except ImportError:
        return _launch_matplotlib(data_dir, params, dims)


def _launch_matplotlib(data_dir, params, dims) -> int:
    import matplotlib.pyplot as plt

    scene = build_scene(data_dir, params, dims)
    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(projection="3d")
    v, f = scene["verts"], scene["faces"]
    if len(v):
        ax.plot_trisurf(v[:, 0], v[:, 1], f, v[:, 2], color=(0.5, 0.5, 0.5, 1.0))
    for ln, col in zip(scene["streamlines"], scene["colors"]):
        ax.plot(ln[:, 0], ln[:, 1], ln[:, 2], color=col, linewidth=0.8)
    ax.set_box_aspect((1, 1, 1))
    plt.show()
    return 0


def _launch_qt_gl(data_dir, params, dims) -> int:
    """PyQt6 + fixed-function OpenGL viewer (the reference's stack). Controls:
    obstacle/streamline checkboxes, proximity/density/length sliders, FPS and
    render-time labels; orbit (LMB), pan (MMB), wheel zoom clamped [10, 500]
    like gl_widget.py:304-358."""
    import sys
    import time
    from PyQt6 import QtCore, QtWidgets
    from PyQt6.QtOpenGLWidgets import QOpenGLWidget
    from OpenGL import GL, GLU

    p = params or ViewerParams()

    class GLView(QOpenGLWidget):
        def __init__(self):
            super().__init__()
            self.scene = {"verts": np.zeros((0, 3)),
                          "faces": np.zeros((0, 3), np.int64),
                          "streamlines": [], "colors": [], "dims": None}
            self.rot = [20.0, -60.0]
            self.pan = [0.0, 0.0]
            self.dist = 150.0
            self._last = None
            self._bg = None           # background_geometry cache
            self._vbo = self._ibo = None
            self._mesh_rev = None     # the uploaded verts array itself

        def initializeGL(self):
            GL.glEnable(GL.GL_DEPTH_TEST)
            GL.glEnable(GL.GL_BLEND)
            GL.glBlendFunc(GL.GL_SRC_ALPHA, GL.GL_ONE_MINUS_SRC_ALPHA)
            GL.glClearColor(0.12, 0.12, 0.14, 1.0)

        def _draw_background(self):
            """Reference grid, axes and domain bbox (gl_widget.py:93-182)."""
            if self.scene.get("dims") is None:
                return
            if self._bg is None or self._bg[0] != self.scene["dims"]:
                self._bg = (self.scene["dims"],
                            background_geometry(*self.scene["dims"]))
            GL.glEnableClientState(GL.GL_VERTEX_ARRAY)
            for segs, rgba, width in self._bg[1].values():
                GL.glColor4f(*rgba)
                GL.glLineWidth(width)
                flat = np.ascontiguousarray(segs.reshape(-1, 3), np.float32)
                GL.glVertexPointer(3, GL.GL_FLOAT, 0, flat)
                GL.glDrawArrays(GL.GL_LINES, 0, len(flat))
            GL.glDisableClientState(GL.GL_VERTEX_ARRAY)
            GL.glLineWidth(1.0)

        def _upload_mesh(self, v, f):
            """VBO + IBO mesh path (gl_widget.py:184-249); buffers are
            (re)filled only when the scene's vertex array changes."""
            if self._vbo is None:
                self._vbo = int(GL.glGenBuffers(1))
                self._ibo = int(GL.glGenBuffers(1))
            GL.glBindBuffer(GL.GL_ARRAY_BUFFER, self._vbo)
            GL.glBindBuffer(GL.GL_ELEMENT_ARRAY_BUFFER, self._ibo)
            # identity check holds a reference to the uploaded array so a
            # GC'd array can never hand its id() to a new mesh (ADVICE r2)
            if self._mesh_rev is not v:
                GL.glBufferData(GL.GL_ARRAY_BUFFER,
                                np.ascontiguousarray(v, np.float32),
                                GL.GL_STATIC_DRAW)
                GL.glBufferData(GL.GL_ELEMENT_ARRAY_BUFFER,
                                np.ascontiguousarray(f, np.uint32),
                                GL.GL_STATIC_DRAW)
                self._mesh_rev = v

        def resizeGL(self, w, h):
            GL.glViewport(0, 0, w, max(1, h))
            GL.glMatrixMode(GL.GL_PROJECTION)
            GL.glLoadIdentity()
            GLU.gluPerspective(45.0, w / max(1, h), 0.1, 2000.0)
            GL.glMatrixMode(GL.GL_MODELVIEW)

        def paintGL(self):
            GL.glClear(GL.GL_COLOR_BUFFER_BIT | GL.GL_DEPTH_BUFFER_BIT)
            GL.glLoadIdentity()
            GL.glTranslatef(self.pan[0], self.pan[1], -self.dist)
            GL.glRotatef(self.rot[0], 1, 0, 0)
            GL.glRotatef(self.rot[1], 0, 1, 0)
            v, f = self.scene["verts"], self.scene["faces"]
            # one world translate shared by background + mesh + streamlines:
            # look at the domain center (dims known) or the mesh centroid
            if self.scene.get("dims"):
                d = self.scene["dims"]
                c = np.asarray(d, np.float32) / 2.0 - 1.0
            elif len(v):
                c = v.mean(axis=0)
            else:
                c = np.zeros(3, np.float32)
            GL.glTranslatef(-c[0], -c[1], -c[2])
            self._draw_background()
            if len(v):
                self._upload_mesh(v, f)
                GL.glColor4f(0.5, 0.5, 0.5, 1.0)
                GL.glEnableClientState(GL.GL_VERTEX_ARRAY)
                GL.glVertexPointer(3, GL.GL_FLOAT, 0, None)   # from the VBO
                GL.glDrawElements(GL.GL_TRIANGLES, f.size, GL.GL_UNSIGNED_INT,
                                  None)                       # from the IBO
                GL.glPolygonMode(GL.GL_FRONT_AND_BACK, GL.GL_LINE)
                GL.glEnable(GL.GL_POLYGON_OFFSET_LINE)
                GL.glPolygonOffset(-1.0, -1.0)
                GL.glColor4f(0.2, 0.2, 0.2, 1.0)
                GL.glDrawElements(GL.GL_TRIANGLES, f.size, GL.GL_UNSIGNED_INT,
                                  None)
                GL.glPolygonMode(GL.GL_FRONT_AND_BACK, GL.GL_FILL)
                GL.glDisableClientState(GL.GL_VERTEX_ARRAY)
                GL.glBindBuffer(GL.GL_ARRAY_BUFFER, 0)
                GL.glBindBuffer(GL.GL_ELEMENT_ARRAY_BUFFER, 0)
            for ln, col in zip(self.scene["streamlines"],
                               self.scene["colors"]):
                GL.glColor4f(*col)
                GL.glBegin(GL.GL_LINE_STRIP)
                for pt in ln:
                    if np.isfinite(pt).all():
                        GL.glVertex3f(*pt)
                GL.glEnd()

        def mousePressEvent(self, e):
            self._last = e.position()

        def mouseMoveEvent(self, e):
            if self._last is None:
                return
            d = e.position() - self._last
            if e.buttons() & QtCore.Qt.MouseButton.LeftButton:
                self.rot[1] += d.x() * 0.5
                self.rot[0] += d.y() * 0.5
            elif e.buttons() & QtCore.Qt.MouseButton.MiddleButton:
                self.pan[0] += d.x() * 0.2
                self.pan[1] -= d.y() * 0.2
            self._last = e.position()
            self.update()

        def wheelEvent(self, e):
            self.dist = float(np.clip(
                self.dist - e.angleDelta().y() * 0.1, 10.0, 500.0))
            self.update()

    class Window(QtWidgets.QMainWindow):
        def __init__(self):
            super().__init__()
            self.setWindowTitle("fluid_simulation 3-D viewer")
            self.resize(1200, 800)
            central = QtWidgets.QWidget(); self.setCentralWidget(central)
            lay = QtWidgets.QHBoxLayout(central)
            self.view = GLView(); lay.addWidget(self.view, 4)
            panel = QtWidgets.QVBoxLayout()
            side = QtWidgets.QWidget(); side.setLayout(panel)
            side.setMaximumWidth(300); lay.addWidget(side, 1)
            self.show_obs = QtWidgets.QCheckBox("Show Obstacles"); self.show_obs.setChecked(True)
            self.show_sl = QtWidgets.QCheckBox("Show Streamlines"); self.show_sl.setChecked(True)
            panel.addWidget(self.show_obs); panel.addWidget(self.show_sl)
            self.sliders = {}
            for name, lo, hi, val in (
                    ("proximity", 1, 30, int(p.streamline_proximity)),
                    ("density", 5, 50, p.streamline_density),
                    ("length", 100, 1000, p.integration_steps)):
                panel.addWidget(QtWidgets.QLabel(f"Streamline {name}:"))
                s = QtWidgets.QSlider(QtCore.Qt.Orientation.Horizontal)
                s.setMinimum(lo); s.setMaximum(hi); s.setValue(val)
                s.valueChanged.connect(self.rebuild)
                panel.addWidget(s); self.sliders[name] = s
            self.fps_label = QtWidgets.QLabel("FPS: --")
            self.rt_label = QtWidgets.QLabel("Render time: -- ms")
            panel.addWidget(self.fps_label); panel.addWidget(self.rt_label)
            panel.addStretch(1)
            self.show_obs.toggled.connect(self.rebuild)
            self.show_sl.toggled.connect(self.rebuild)
            self._tick = time.time()
            timer = QtCore.QTimer(self)
            timer.timeout.connect(self._fps)
            timer.start(1000)
            self.rebuild()

        def rebuild(self):
            t0 = time.time()
            p.streamline_proximity = self.sliders["proximity"].value()
            p.streamline_density = self.sliders["density"].value()
            p.integration_steps = self.sliders["length"].value()
            self.view.scene = build_scene(
                data_dir, p, dims,
                show_obstacles=self.show_obs.isChecked(),
                show_streamlines=self.show_sl.isChecked())
            self.view.update()
            self.rt_label.setText(
                f"Render time: {(time.time() - t0) * 1000:.1f} ms")

        def _fps(self):
            now = time.time()
            dt = now - self._tick
            if dt > 0:
                self.fps_label.setText(f"FPS: {1.0 / dt:.1f}")
            self._tick = now

    app = QtWidgets.QApplication(sys.argv[:1])
    app.setStyle("Fusion")
    w = Window(); w.show()
    return app.exec()
