#!/bin/sh
# Build the native helpers, run a simulation, open the viewer — the
# one-command flow the reference's run.sh provides (make; ./simulation.out;
# python GUI/main.py), without its hardcoded absolute paths. Output lands in
# ./data relative to the caller's directory.
set -e
REPO_DIR=$(CDPATH= cd -- "$(dirname -- "$0")" && pwd)
make -C "$REPO_DIR/fluid_simulation/native" -s \
    || echo "native build unavailable; using NumPy fallbacks"
PYTHONPATH="$REPO_DIR${PYTHONPATH:+:$PYTHONPATH}" \
    python -m fluid_simulation.cli run --dump-dir data "$@"
# End with the 3-D viewer like the reference launcher (run.sh:4 ->
# GUI/main.py); it falls back to a matplotlib 3-D scene when PyQt6/OpenGL
# are unavailable, and we fall back to the 2-D slice viewer if even that
# fails (e.g. no display).
PYTHONPATH="$REPO_DIR${PYTHONPATH:+:$PYTHONPATH}" \
    python -m fluid_simulation.cli view3d --data-dir data \
    || PYTHONPATH="$REPO_DIR${PYTHONPATH:+:$PYTHONPATH}" \
       python -m fluid_simulation.cli view --data-dir data
