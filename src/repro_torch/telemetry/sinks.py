"""Streaming telemetry sinks (the counterpart of the JAX package's
``repro/telemetry/sinks.py``).

The default :class:`~repro_torch.telemetry.collector.Telemetry` keeps
every round record in memory and writes one JSONL file at export time.
A *sink* receives each record the moment it exists instead:

- ``emit_meta(rec)`` once, when the collector is created;
- ``emit_round(rec)`` at every ``end_round`` boundary;
- ``close(summary)`` when the session ends (the run summary, if the
  caller computed one).

Attach one via ``telemetry.enable(sink=...)`` or
``telemetry.session(sink=...)``; pair it with ``retain_rounds=`` to
bound the collector's in-memory window.  With no sink attached nothing
changes.

:class:`JsonlSink` writes the same line-delimited schema as
:func:`repro_torch.telemetry.export.export_jsonl` (meta line, round
records, summary line), flushed per round so a killed run leaves every
completed round on disk, with optional size-based rotation: when the live
file would exceed ``rotate_bytes`` it is renamed to ``<path>.<k>`` (k
increasing with age) and a fresh file re-opens at ``path`` starting with
a copy of the meta line — every part parses alone with
:func:`repro_torch.telemetry.export.read_jsonl`.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional


class Sink:
    """Base streaming sink: every hook is a no-op; subclasses override
    what they need.  Hooks must never raise into the round loop (a
    telemetry failure must not kill a federation)."""

    def emit_meta(self, rec: Dict[str, Any]) -> None:
        pass

    def emit_round(self, rec: Dict[str, Any]) -> None:
        pass

    def close(self, summary: Optional[Dict[str, Any]] = None) -> None:
        pass


class JsonlSink(Sink):
    """Append-per-round JSONL file sink with optional size rotation.

    ``rotate_bytes=0`` (default) never rotates.  ``append=True`` opens
    an existing file for appending instead of truncating — for resumed
    runs sharing one telemetry file (the new session's meta line marks
    the boundary).
    """

    def __init__(self, path: str, *, rotate_bytes: int = 0,
                 append: bool = False):
        if rotate_bytes < 0:
            raise ValueError(f"rotate_bytes must be >= 0, got "
                             f"{rotate_bytes}")
        self.path = path
        self.rotate_bytes = int(rotate_bytes)
        self.parts = 0                       # rotated-out file count
        self._meta_line: Optional[str] = None
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a" if append else "w")

    # -- hooks ---------------------------------------------------------------
    def emit_meta(self, rec: Dict[str, Any]) -> None:
        self._meta_line = json.dumps(rec, sort_keys=True)
        self._write(self._meta_line)

    def emit_round(self, rec: Dict[str, Any]) -> None:
        self._write(json.dumps(rec, sort_keys=True))

    def close(self, summary: Optional[Dict[str, Any]] = None) -> None:
        if self._f.closed:
            return
        if summary is not None:
            self._write(json.dumps(summary, sort_keys=True))
        self._f.close()

    # -- mechanics -----------------------------------------------------------
    def _write(self, line: str) -> None:
        if self.rotate_bytes and self._f.tell() > 0 \
                and self._f.tell() + len(line) + 1 > self.rotate_bytes:
            self._rotate()
        self._f.write(line + "\n")
        self._f.flush()

    def _rotate(self) -> None:
        """Roll the live file out to ``<path>.<k>`` and re-open fresh,
        re-stamping the meta line so the new part parses alone."""
        self._f.close()
        self.parts += 1
        os.replace(self.path, f"{self.path}.{self.parts}")
        self._f = open(self.path, "w")
        if self._meta_line is not None:
            self._f.write(self._meta_line + "\n")

    def rotated_paths(self) -> List[str]:
        """Rolled-out part paths, oldest first (the live file is
        ``self.path``)."""
        return [f"{self.path}.{k}" for k in range(1, self.parts + 1)]


def finalize_sink(tel) -> None:
    """Flush a collector's trailing partial round into its sink and
    close the sink with the run summary.  No-op without a sink."""
    sink = getattr(tel, "sink", None)
    if sink is None:
        return
    from repro_torch.telemetry.export import summarize
    tel.flush_pending()
    sink.close(summarize(tel))
