"""Frame dump I/O in the reference's exact binary contract.

Contract (SURVEY.md §1 L4): per step, one full *padded* float32 frame of each
of five fields appended to ``data/{data,obs,v_x,v_y,v_z}.bin``, x-fastest
layout (``simulation.cpp:143-147``, ``simulation.h:9``) — so the reference's
own viewers (gui.py, GUI/main.py, make_pngs.py) can read our dumps unmodified.
Our arrays are already (D+2, H+2, W+2) row-major, i.e. byte-identical order.

Improvements over the reference:

- a ``meta.json`` sidecar records grid dims + params, killing the hand-synced
  dims problem (``GUI/config.py:8-11`` vs ``gui.py:32-34`` vs
  ``make_pngs.py:7-8`` are three different hardcoded sizes — SURVEY.md §5);
- writes happen on a background thread (the reference's single-threaded
  11.3 MB/step write stalls its step loop, ``simulation.cpp:140-148``); a
  C++ writer (native/) can be swapped in via ``backend='native'``;
- the static obstacle field is still duplicated per frame for compatibility,
  but ``write_obs_once=True`` can store a single copy instead.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from fluid_simulation.config import SimParams

# field-key -> filename, in the reference's write order (simulation.cpp:143-147)
FIELD_FILES = (
    ("dens", "data.bin"),
    ("obs", "obs.bin"),
    ("vx", "v_x.bin"),
    ("vy", "v_y.bin"),
    ("vz", "v_z.bin"),
)


class FrameWriter:
    """Append-mode frame writer with an optional background flush thread."""

    def __init__(self, out_dir: str, params: Optional[SimParams] = None,
                 async_io: bool = True, write_obs_once: bool = False,
                 backend: str = "python"):
        self.out_dir = out_dir
        self.write_obs_once = write_obs_once
        self._obs_written = False
        os.makedirs(out_dir, exist_ok=True)
        self._native = None
        if backend == "native":
            try:
                from fluid_simulation.native import framewriter as _nfw
                self._native = _nfw.NativeFrameWriter(
                    [os.path.join(out_dir, fn) for _, fn in FIELD_FILES])
            except Exception:
                self._native = None  # fall back to python path
        if self._native is None:
            self._files = {
                key: open(os.path.join(out_dir, fn), "wb")
                for key, fn in FIELD_FILES
            }
        if params is not None:
            self.write_meta(params)
        self._q: Optional[queue.Queue] = None
        if async_io and self._native is None:
            self._q = queue.Queue(maxsize=8)
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    def write_meta(self, params: SimParams, extra: Optional[dict] = None):
        meta = json.loads(params.to_json())
        meta["padded_shape"] = list(params.padded_shape)
        meta["field_files"] = dict(FIELD_FILES)
        meta["layout"] = "zyx_row_major (x fastest, reference simulation.h:9)"
        if extra:
            meta.update(extra)
        with open(os.path.join(self.out_dir, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2, sort_keys=True)

    # -- frame path ---------------------------------------------------------
    def append(self, fields: Dict[str, np.ndarray]):
        """Queue one frame. ``fields`` maps the FIELD_FILES keys to padded
        arrays (any dtype; converted to f32 to honor the contract)."""
        buf = {}
        for key, _ in FIELD_FILES:
            if key == "obs" and self.write_obs_once and self._obs_written:
                continue
            arr = np.ascontiguousarray(
                np.asarray(fields[key]), dtype=np.float32)
            buf[key] = arr
        self._obs_written = True
        if self._native is not None:
            self._native.append([buf.get(k) for k, _ in FIELD_FILES])
        elif self._q is not None:
            self._q.put(buf)
        else:
            self._write(buf)

    def _write(self, buf):
        for key, arr in buf.items():
            self._files[key].write(arr.tobytes())

    def _drain(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            self._write(item)
            self._q.task_done()

    def close(self):
        if self._native is not None:
            self._native.close()
            return
        if self._q is not None:
            self._q.put(None)
            self._worker.join()
        for f in self._files.values():
            f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _resolve_dims(data_dir: str,
                  dims: Optional[Tuple[int, int, int]]) -> Tuple[int, int, int]:
    """Padded (W2, H2, D2), from meta.json if present (reference dumps have
    none — callers pass interior dims like the GUIs hardcode them)."""
    meta_path = os.path.join(data_dir, "meta.json")
    if dims is not None:
        W, H, D = dims
        return W + 2, H + 2, D + 2
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        D2, H2, W2 = meta["padded_shape"]
        return W2, H2, D2
    raise ValueError(
        f"no meta.json in {data_dir}; pass dims=(W, H, D) explicitly")


def read_run(data_dir: str, dims: Optional[Tuple[int, int, int]] = None
             ) -> Dict[str, np.ndarray]:
    """Load all frames of all five fields as (T, D+2, H+2, W+2) arrays —
    the 2-D viewer's loading semantics (gui.py:215-242), incl. the
    whole-number-of-frames assertion (gui.py:229)."""
    W2, H2, D2 = _resolve_dims(data_dir, dims)
    frame = W2 * H2 * D2
    out = {}
    for key, fn in FIELD_FILES:
        path = os.path.join(data_dir, fn)
        arr = np.fromfile(path, dtype=np.float32)
        if arr.size % frame != 0:
            raise ValueError(f"bad size in {fn}: {arr.size} not a multiple of "
                             f"frame {frame}")
        out[key] = arr.reshape(-1, D2, H2, W2)
    n = {k: v.shape[0] for k, v in out.items()}
    if len({v for k, v in n.items() if k != "obs"}) > 1:
        raise ValueError(f"inconsistent frame counts: {n}")
    return out


def read_last_frame(data_dir: str, dims: Optional[Tuple[int, int, int]] = None
                    ) -> Dict[str, np.ndarray]:
    """Seek-to-EOF read of only the final frame (the 3-D viewer's loading
    semantics, GUI/main_window.py:149-182)."""
    W2, H2, D2 = _resolve_dims(data_dir, dims)
    frame = W2 * H2 * D2
    out = {}
    for key, fn in FIELD_FILES:
        path = os.path.join(data_dir, fn)
        size = os.path.getsize(path)
        if size % (frame * 4) != 0:
            raise ValueError(f"invalid file size in {fn}: {size} bytes")
        with open(path, "rb") as f:
            f.seek(-frame * 4, os.SEEK_END)
            data = np.fromfile(f, dtype=np.float32, count=frame)
        out[key] = data.reshape(D2, H2, W2)
    return out


class SimulationDiverged(RuntimeError):
    """Raised by the NaN watchdog; carries the last-good checkpoint path."""

    def __init__(self, step, ckpt_path):
        super().__init__(
            f"non-finite fields at step {step}"
            + (f"; last good checkpoint: {ckpt_path}" if ckpt_path else ""))
        self.step = step
        self.ckpt_path = ckpt_path


def run_and_dump(wt, steps: int, out_dir: str, chunk: int = 10,
                 async_io: bool = True, backend: str = "python",
                 guard_nan: bool = True):
    """Advance a WindTunnel ``steps`` steps, streaming every frame to disk in
    the reference contract. The scan runs on device in ``chunk``-step bursts;
    transfers overlap the next burst via the writer thread.

    ``guard_nan`` adds a failure detector the reference lacks (SURVEY.md §5):
    each flushed burst is checked for non-finite fields; on divergence the
    last good state is checkpointed next to the dump and
    ``SimulationDiverged`` raised, so long runs never silently write garbage.
    """
    obs_np = np.asarray(wt.obstacles, dtype=np.float32)
    # (vx, vy, vz, dens) host copies of the last finite state, in the global
    # padded layout (a ShardedWindTunnel's .state is slab-stacked — its
    # global_state() stitches; recorded bursts below arrive pre-stitched)
    if guard_nan:
        src = wt.global_state() if hasattr(wt, "global_state") else wt.state
        last_good = tuple(np.asarray(f) for f in src)
    else:
        last_good = None
    with FrameWriter(out_dir, wt.params, async_io=async_io,
                     backend=backend) as w:
        done = 0
        while done < steps:
            n = min(chunk, steps - done)
            _, ys = wt.simulate(steps=n, record=True)
            _, states = ys
            host = {k: np.asarray(v) for k, v in states._asdict().items()}
            if guard_nan and not all(np.isfinite(v).all()
                                     for v in host.values()):
                from fluid_simulation.io.checkpoint import save_checkpoint
                from fluid_simulation.models.windtunnel import FluidState
                ckpt = save_checkpoint(
                    os.path.join(out_dir, "emergency_ckpt"),
                    FluidState(**{k: last_good[i] for i, k in
                                  enumerate(("vx", "vy", "vz", "dens"))}),
                    done, wt.params, obstacles=obs_np)
                raise SimulationDiverged(done + n, ckpt)
            for i in range(n):
                w.append({
                    "dens": host["dens"][i], "obs": obs_np,
                    "vx": host["vx"][i], "vy": host["vy"][i],
                    "vz": host["vz"][i],
                })
            done += n
            if guard_nan:
                last_good = (host["vx"][-1], host["vy"][-1],
                             host["vz"][-1], host["dens"][-1])
    return wt.state
