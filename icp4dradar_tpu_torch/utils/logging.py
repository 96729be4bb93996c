"""Structured JSONL metrics logging (a copy of
`icp4dradar_tpu/utils/logging.py` without jax): machine-readable records in
place of the reference's per-frame console output."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    """Append-only JSONL metrics stream with a monotonic step counter. Each
    record is {"ts", "step", "event", **fields}, flushed as it is written;
    `echo` also prints it. Close it, or use it as a context manager."""

    def __init__(self, path: Optional[str] = None, echo: bool = False):
        self.path = path
        self.echo = echo
        self.step = 0
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a")
        else:
            self._f = None

    def log(self, event: str, **fields: Any) -> Dict[str, Any]:
        rec = {"ts": time.time(), "step": self.step, "event": event, **fields}
        self.step += 1
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        if self.echo:
            print(json.dumps(rec))
        return rec

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
