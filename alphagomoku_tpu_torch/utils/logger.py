"""Global redirectable logger (reference: include/alphagomoku/utils/
Logger.hpp:18-33 — mutex-guarded singleton writing to a swappable stream;
the engine redirects it to per-session timestamped files under logs/,
ProgramManager.cpp:467-477).  A copy of the reference package's
`utils/logger.py`."""

from __future__ import annotations

import datetime
import os
import sys
import threading
from typing import IO


class Logger:
    _lock = threading.Lock()
    _stream: IO[str] | None = None
    _enabled = False

    @classmethod
    def enable(cls, stream: IO[str] | None = None) -> None:
        with cls._lock:
            cls._stream = stream if stream is not None else sys.stderr
            cls._enabled = True

    @classmethod
    def redirect_to_file(cls, log_dir: str = "logs") -> str:
        """Timestamped per-session logfile (reference behavior)."""
        os.makedirs(log_dir, exist_ok=True)
        stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
        path = os.path.join(log_dir, f"session_{stamp}.log")
        cls.enable(open(path, "a"))
        return path

    @classmethod
    def disable(cls) -> None:
        with cls._lock:
            cls._enabled = False

    @classmethod
    def write(cls, where: str, what: str) -> None:
        with cls._lock:
            if cls._enabled and cls._stream is not None:
                cls._stream.write(f"[{where}] {what}\n")
                cls._stream.flush()


def log(where: str, what: str) -> None:
    Logger.write(where, what)
