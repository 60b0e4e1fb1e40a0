"""2-D slice viewer.

Feature parity with the reference viewer (gui.py:128-354): time slider,
z-slice slider, field selector (Density / Velocity X / Y / Z), optional X/Y
velocity-vector overlay on the density view, obstacle darkening, status bar.

Backends, picked at launch:
- PyQt6 when importable (the reference's stack);
- matplotlib widgets otherwise (works over any matplotlib backend);
- both share the pure-NumPy frame composer ``compose_frame`` below, which is
  what the tests exercise headlessly.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from fluid_simulation.io.dump import read_run
from fluid_simulation.viz.colormap import apply_colormap, overlay_obstacle
from fluid_simulation.viz.slices import FIELD_RANGES

_FIELD_LABELS = {
    "Density": "dens", "Velocity X": "vx", "Velocity Y": "vy",
    "Velocity Z": "vz",
}


def compose_frame(run: Dict[str, np.ndarray], frame: int, z: int,
                  field: str = "Density", vectors: bool = True,
                  skip: int = 30, scale: float = 0.2) -> np.ndarray:
    """One displayed image as (H+2, W+2, 3) uint8: colormapped slice +
    obstacle overlay + (density only) velocity arrows drawn into the bitmap
    (the QPainter arrows of gui.py:82-123, rasterized with Bresenham-ish
    strokes so no GUI toolkit is needed)."""
    key = _FIELD_LABELS[field]
    vmin, vmax = FIELD_RANGES[key]
    sl = run[key][frame, z]
    rgb = apply_colormap(sl, vmin, vmax)
    obs_frame = min(frame, run["obs"].shape[0] - 1)
    rgb = overlay_obstacle(rgb, run["obs"][obs_frame, z], alpha=0.2)
    if vectors and key == "dens":
        rgb = _draw_vectors(rgb, run["vx"][frame, z], run["vy"][frame, z],
                            skip=skip, scale=scale)
    return rgb


def _draw_vectors(rgb: np.ndarray, vx: np.ndarray, vy: np.ndarray,
                  skip: int = 30, scale: float = 0.2,
                  color=(255, 255, 0)) -> np.ndarray:
    """Yellow arrows every `skip` pixels where speed >= 0.02 (gui.py:98-120)."""
    out = rgb.copy()
    h, w = vx.shape
    head_len, head_angle = 6.0, np.radians(30)
    for y in range(skip // 2, h, skip):
        for x in range(skip // 2, w, skip):
            u, v = float(vx[y, x]), float(vy[y, x])
            if np.hypot(u, v) < 0.02:
                continue
            ex, ey = x + u * scale, y + v * scale
            _stroke(out, x, y, ex, ey, color)
            th = np.arctan2(v, u)
            for sign in (+1.0, -1.0):
                hx = ex - head_len * np.cos(th + sign * head_angle)
                hy = ey - head_len * np.sin(th + sign * head_angle)
                _stroke(out, ex, ey, hx, hy, color)
    return out


def _stroke(img: np.ndarray, x0, y0, x1, y1, color):
    n = max(2, int(np.hypot(x1 - x0, y1 - y0)) * 2)
    xs = np.clip(np.linspace(x0, x1, n) + 0.5, 0, img.shape[1] - 1).astype(int)
    ys = np.clip(np.linspace(y0, y1, n) + 0.5, 0, img.shape[0] - 1).astype(int)
    img[ys, xs] = color


def launch_viewer(data_dir: str, dims: Optional[Tuple[int, int, int]] = None) -> int:
    run = read_run(data_dir, dims=dims)
    try:
        return _launch_qt(run)
    except ImportError:
        return _launch_matplotlib(run)


def _launch_qt(run) -> int:
    import sys
    from PyQt6 import QtCore, QtGui, QtWidgets

    class Viewer(QtWidgets.QMainWindow):
        def __init__(self):
            super().__init__()
            self.setWindowTitle("fluid_simulation slice viewer")
            self.resize(1000, 700)
            c = QtWidgets.QWidget(); self.setCentralWidget(c)
            v = QtWidgets.QVBoxLayout(c)
            self.label = QtWidgets.QLabel(alignment=QtCore.Qt.AlignmentFlag.AlignCenter)
            self.label.setSizePolicy(QtWidgets.QSizePolicy.Policy.Expanding,
                                     QtWidgets.QSizePolicy.Policy.Expanding)
            v.addWidget(self.label, 1)
            ctrl = QtWidgets.QHBoxLayout(); v.addLayout(ctrl)
            T, D2 = run["dens"].shape[0], run["dens"].shape[1]
            self.t = QtWidgets.QSlider(QtCore.Qt.Orientation.Horizontal)
            self.t.setMaximum(T - 1)
            self.z = QtWidgets.QSlider(QtCore.Qt.Orientation.Horizontal)
            self.z.setMaximum(D2 - 1); self.z.setValue(D2 // 2)
            self.field = QtWidgets.QComboBox()
            self.field.addItems(list(_FIELD_LABELS))
            self.vec = QtWidgets.QCheckBox("Show vectors"); self.vec.setChecked(True)
            for w, name in ((self.t, "Frame:"), (self.z, "Slice:")):
                ctrl.addWidget(QtWidgets.QLabel(name)); ctrl.addWidget(w, 1)
            ctrl.addWidget(self.field); ctrl.addWidget(self.vec)
            for w in (self.t, self.z):
                w.valueChanged.connect(self.redraw)
            self.field.currentIndexChanged.connect(self.redraw)
            self.vec.toggled.connect(self.redraw)
            self.redraw()

        def redraw(self):
            rgb = compose_frame(run, self.t.value(), self.z.value(),
                                self.field.currentText(), self.vec.isChecked())
            h, w, _ = rgb.shape
            img = QtGui.QImage(rgb.tobytes(), w, h, 3 * w,
                               QtGui.QImage.Format.Format_RGB888).copy()
            pix = QtGui.QPixmap.fromImage(img)
            self.label.setPixmap(pix.scaled(
                self.label.size(), QtCore.Qt.AspectRatioMode.KeepAspectRatio,
                QtCore.Qt.TransformationMode.SmoothTransformation))
            self.statusBar().showMessage(
                f"frame {self.t.value() + 1}/{run['dens'].shape[0]}  "
                f"slice {self.z.value()}")

        def resizeEvent(self, e):
            super().resizeEvent(e); self.redraw()

    app = QtWidgets.QApplication(sys.argv[:1])
    v = Viewer(); v.show()
    return app.exec()


def _launch_matplotlib(run) -> int:
    import matplotlib.pyplot as plt
    from matplotlib.widgets import Slider, RadioButtons

    T, D2 = run["dens"].shape[0], run["dens"].shape[1]
    fig, ax = plt.subplots(figsize=(10, 6))
    plt.subplots_adjust(bottom=0.22, left=0.25)
    state = {"field": "Density"}
    im = ax.imshow(compose_frame(run, 0, D2 // 2))
    ax.set_axis_off()
    axt = plt.axes([0.3, 0.10, 0.6, 0.03])
    axz = plt.axes([0.3, 0.05, 0.6, 0.03])
    st = Slider(axt, "frame", 0, T - 1, valinit=0, valstep=1)
    sz = Slider(axz, "slice", 0, D2 - 1, valinit=D2 // 2, valstep=1)
    axr = plt.axes([0.02, 0.4, 0.18, 0.25])
    rb = RadioButtons(axr, list(_FIELD_LABELS))

    def update(_=None):
        im.set_data(compose_frame(run, int(st.val), int(sz.val),
                                  state["field"]))
        fig.canvas.draw_idle()

    def set_field(label):
        state["field"] = label; update()

    st.on_changed(update); sz.on_changed(update); rb.on_clicked(set_field)
    plt.show()
    return 0
