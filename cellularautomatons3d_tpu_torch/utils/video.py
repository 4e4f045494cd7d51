"""Frame-sequence sink: record engine runs to disk.

Copied from ``cellularautomatons3d_tpu.utils.video``: PNG sequences plus an
index for offline viewing or encoding, through :mod:`.image` (the native
encoder when it builds).  Frames may be tensors on the card.
"""

from __future__ import annotations

import json
import os

from . import image

__all__ = ["FrameRecorder", "record"]


class FrameRecorder:
    """Writes ``frame_%06d.png`` plus ``index.json`` into a directory."""

    def __init__(self, directory: str, level: int = 1):
        self.directory = directory
        self.level = level
        self.count = 0
        os.makedirs(directory, exist_ok=True)

    def __call__(self, idx: int, frame) -> None:
        data = image.encode_png(frame, level=self.level)
        path = os.path.join(self.directory, f"frame_{self.count:06d}.png")
        with open(path, "wb") as f:
            f.write(data)
        self.count += 1

    def close(self) -> None:
        with open(os.path.join(self.directory, "index.json"), "w") as f:
            json.dump({"frames": self.count, "pattern": "frame_%06d.png"}, f)


def record(engine, directory: str, frames: int, dt_ms: float = 16.667):
    """Run the engine frame loop and record every frame."""
    rec = FrameRecorder(directory)
    engine.run(frames, dt_ms=dt_ms, sink=rec)
    rec.close()
    return rec.count
