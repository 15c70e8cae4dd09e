"""[Copy of audiorenderingv2_tpu/utils/logging.py: numpy-free, kept equal to it by tests/test_torch_logging.py.]

Structured event logging (JSONL).

The reference's observability is unstructured ``std::cout`` (SURVEY §5 —
"Time taken by Optix" prints, AudioRenderer.cpp:495-518, with no levels and
no files). This module is the rebuild's structured replacement: one logger,
events as single-line JSON records with a wall-clock timestamp, writable to
a file and/or stderr, cheap enough to leave on in production loops.

Usage::

    from audiorenderingv2_tpu.utils.logging import get_logger, configure

    configure(path="run.jsonl")           # optional; default stderr-off
    log = get_logger()
    log.event("render", ms=125.4, n_rays=1_000_000)

Every record carries ``ts`` (unix seconds), ``event``, and the keyword
fields. The logger is process-global and thread-safe (one lock per write);
rendering hot loops call it once per render, not per ray, so the cost is a
dict + one line of IO.
"""
from __future__ import annotations

import json
import sys
import threading
import time
from typing import IO


class EventLogger:
    """JSONL event logger; see module docstring."""

    def __init__(self, path: str | None = None, stream: IO | None = None):
        self._lock = threading.Lock()
        self._file = open(path, "a", buffering=1) if path else None
        self._stream = stream
        self.records = 0

    def event(self, event: str, **fields) -> dict:
        """Emit one structured record; returns it (handy for tests)."""
        rec = {"ts": round(time.time(), 6), "event": event, **fields}
        line = json.dumps(rec, default=str)
        with self._lock:
            if self._file is not None:
                self._file.write(line + "\n")
            if self._stream is not None:
                self._stream.write(line + "\n")
                self._stream.flush()
            self.records += 1
        return rec

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


_logger: EventLogger | None = None


def configure(path: str | None = None, to_stderr: bool = False) -> EventLogger:
    """(Re)configure the process-global logger."""
    global _logger
    if _logger is not None:
        _logger.close()
    _logger = EventLogger(path, sys.stderr if to_stderr else None)
    return _logger


def get_logger() -> EventLogger:
    """The process-global logger (a silent sink until configured)."""
    global _logger
    if _logger is None:
        _logger = EventLogger()
    return _logger
