"""Structured per-frame logging (SURVEY.md §5.5).

The reference threads a std.experimental.logger through the GUI classes
and printf-dumps scene loads and camera moves (gui_base.d:17-23,
raytracer_demo.d:156).  The TPU-native equivalent owed by the survey is a
*structured* metrics stream: one JSON record per event (frame rendered,
scene loaded, checkpoint written), machine-parseable, with a process-wide
default sink.

Usage::

    from chess2rt_tpu_torch.utils.structlog import get_logger
    log = get_logger()
    with log.frame(scene="lecture5", width=1920, height=1080) as rec:
        img = render(...)
        rec["rays"] = 21_000_000
    # -> {"event": "frame", "scene": ..., "wall_ms": 503.1, "rays": ...}
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from typing import Any, Dict, List, Optional


class StructLogger:
    """JSON-lines event logger with an in-memory ring of recent records."""

    def __init__(self, stream=None, keep: int = 256):
        self.stream = stream  # None = silent (records still kept)
        self.keep = keep
        self.records: List[Dict[str, Any]] = []

    def emit(self, event: str, **fields) -> Dict[str, Any]:
        rec = {"event": event, "t": time.time(), **fields}
        self.records.append(rec)
        if len(self.records) > self.keep:
            del self.records[: -self.keep]
        if self.stream is not None:
            self.stream.write(json.dumps(rec, default=float) + "\n")
            self.stream.flush()
        return rec

    @contextlib.contextmanager
    def frame(self, **fields):
        """Times a frame render; fields added inside the block are kept.
        The record is emitted even when the block raises (failed frames
        are exactly what the log is for); ``error`` carries the reason."""
        rec: Dict[str, Any] = dict(fields)
        t0 = time.perf_counter()
        try:
            yield rec
        except BaseException as e:
            rec["error"] = f"{type(e).__name__}: {e}"
            raise
        finally:
            rec["wall_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
            self.emit("frame", **rec)


_default: Optional[StructLogger] = None


def get_logger() -> StructLogger:
    """Process-wide default logger (silent sink until configured)."""
    global _default
    if _default is None:
        _default = StructLogger(stream=None)
    return _default


def configure(stream=sys.stderr, keep: int = 256) -> StructLogger:
    """Point the default logger at a stream (e.g. sys.stderr or a file)."""
    global _default
    _default = StructLogger(stream=stream, keep=keep)
    return _default
