"""Telemetry sinks — where serialized JSONL records go.

Sinks receive *pre-serialized* lines (no trailing newline) so the hot
path pays the ``json.dumps`` cost exactly once and a sink never has to
understand record schemas. :class:`JsonlSink` is bounded: when the
active file would exceed ``max_bytes`` it shift-rotates
(``f.jsonl.1`` → ``f.jsonl.2`` …, oldest dropped past ``max_files``),
so a long-running process can emit forever without unbounded disk use.
"""
from __future__ import annotations

import os
import threading
from typing import List


class Sink:
    """Destination for serialized telemetry lines."""

    def write_line(self, line: str) -> None:
        raise NotImplementedError

    def flush(self) -> None:  # pragma: no cover - trivial default
        pass

    def close(self) -> None:  # pragma: no cover - trivial default
        pass


class NullSink(Sink):
    """Discards everything. Used when telemetry is disabled."""

    def write_line(self, line: str) -> None:
        pass


class MemorySink(Sink):
    """Accumulates lines in memory — the workhorse for tests."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.lines: List[str] = []

    def write_line(self, line: str) -> None:
        with self._lock:
            self.lines.append(line)

    def text(self) -> str:
        with self._lock:
            return "".join(ln + "\n" for ln in self.lines)


class JsonlSink(Sink):
    """Rotating JSONL file sink with explicit flush.

    Writes are buffered by the underlying file object; callers that need
    durability (benchmarks before reading the file back, examples before
    exit) call :meth:`flush`. Rotation keeps at most ``max_files``
    historical files of roughly ``max_bytes`` each.
    """

    def __init__(self, path: str, *, max_bytes: int = 64 * 1024 * 1024,
                 max_files: int = 4) -> None:
        if max_bytes <= 0:
            raise ValueError("max_bytes must be positive")
        self.path = str(path)
        self.max_bytes = int(max_bytes)
        self.max_files = int(max_files)
        self._lock = threading.Lock()
        self._fh = None
        self._size = 0

    def _open(self) -> None:
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._fh = open(self.path, "a", encoding="utf-8")
        self._size = self._fh.tell()

    def _rotate(self) -> None:
        self._fh.close()
        self._fh = None
        if self.max_files <= 1:
            os.remove(self.path)
        else:
            oldest = f"{self.path}.{self.max_files - 1}"
            if os.path.exists(oldest):
                os.remove(oldest)
            for i in range(self.max_files - 1, 0, -1):
                src = self.path if i == 1 else f"{self.path}.{i - 1}"
                if os.path.exists(src):
                    os.replace(src, f"{self.path}.{i}")
        self._open()

    def write_line(self, line: str) -> None:
        data = line + "\n"
        with self._lock:
            if self._fh is None:
                self._open()
            if self._size + len(data) > self.max_bytes and self._size > 0:
                self._rotate()
            self._fh.write(data)
            self._size += len(data)

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
