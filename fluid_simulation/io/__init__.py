"""I/O layer: the reference's binary frame-dump contract, sidecar metadata,
async streaming, and checkpoint/resume (a strict capability superset — the
reference dumps every frame but has no code path to load one back,
SURVEY.md §5)."""

from fluid_simulation.io.dump import (
    FrameWriter,
    read_run,
    read_last_frame,
    run_and_dump,
    FIELD_FILES,
)
from fluid_simulation.io.checkpoint import (
    save_checkpoint,
    load_checkpoint,
    latest_checkpoint,
)

__all__ = [
    "FrameWriter",
    "read_run",
    "read_last_frame",
    "run_and_dump",
    "FIELD_FILES",
    "save_checkpoint",
    "load_checkpoint",
    "latest_checkpoint",
]
