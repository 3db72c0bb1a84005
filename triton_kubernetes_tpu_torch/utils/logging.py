"""Structured logging -- the port's copy of
``triton_kubernetes_tpu/utils/logging.py``: ``Logger`` writes leveled
records as text or, with ``json_mode`` (the trainer's ``--json-logs``),
one JSON object a line (ts, level, msg, the record's fields); ``Span`` is a
context manager that times a phase and logs its end with the duration.
Spans nest; children carry their parent chain in the ``span`` field, so a
JSON consumer can rebuild the phase tree. ``configure``/``get_logger``
hold the process-default logger.

No external deps: a small core, not a logging framework.
"""

from __future__ import annotations

import contextlib
import json
import sys
import threading
import time
from typing import TYPE_CHECKING, Any, Dict, List, Optional, TextIO

if TYPE_CHECKING:  # pragma: no cover
    from .trace import TraceCollector

LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40}


def _level_no(level: str) -> int:
    """Numeric level, or ValueError naming the valid choices — a typo'd
    level must not surface as a bare KeyError deep in a log call."""
    try:
        return LEVELS[level]
    except KeyError:
        raise ValueError(
            f"unknown log level {level!r} "
            f"(valid: {sorted(LEVELS, key=LEVELS.get)})") from None


class Logger:
    """Leveled logger writing text or JSON lines to a stream.

    Text mode is what a human watches during ``create cluster``; JSON mode
    (one object per line: ts, level, msg, plus event fields) is for driving
    the CLI from automation, the analog of the silent-install contract.
    """

    def __init__(self, stream: Optional[TextIO] = None, *,
                 json_mode: bool = False, level: str = "info",
                 trace: Optional["TraceCollector"] = None,
                 fields: Optional[Dict[str, Any]] = None):
        # None = "current sys.stderr", resolved at emit time so the logger
        # follows stream redirection (pytest capsys, daemonized CLIs).
        self._stream = stream
        self.json_mode = json_mode
        self.level_no = _level_no(level)
        # Fields stamped on EVERY record (rank tags under multi-process
        # training: process=N); per-call fields win on collision.
        self.bound_fields: Dict[str, Any] = dict(fields or {})
        # Optional span sink (utils/trace.TraceCollector): every finished
        # span is exported as a Chrome trace event (--trace-out).
        self.trace = trace
        self._lock = threading.Lock()
        self._span_stack = threading.local()

    # ------------------------------------------------------------------ emit
    def bind(self, **fields: Any) -> "Logger":
        """Stamp ``fields`` on every subsequent record (e.g.
        ``log.bind(process=jax.process_index())`` after distributed
        init). Returns self for chaining."""
        self.bound_fields.update(fields)
        return self

    def log(self, level: str, msg: str, **fields: Any) -> None:
        if _level_no(level) < self.level_no:
            return
        if self.bound_fields:
            fields = {**self.bound_fields, **fields}
        spans = self._spans()
        if self.json_mode:
            rec: Dict[str, Any] = {"ts": round(time.time(), 3),
                                   "level": level, "msg": msg}
            if spans:
                rec["span"] = "/".join(s.name for s in spans)
            rec.update(fields)
            line = json.dumps(rec, sort_keys=True, default=str)
        else:
            # Full parent/child chain, same shape as the JSON `span` field
            # (text mode used to truncate to the innermost span).
            prefix = (f"[{'/'.join(s.name for s in spans)}] "
                      if spans else "")
            extras = " ".join(f"{k}={v}" for k, v in fields.items())
            line = f"{prefix}{msg}" + (f"  ({extras})" if extras else "")
            if level in ("warn", "error"):
                line = f"{level}: {line}"
        with self._lock:
            print(line, file=self._stream if self._stream is not None
                  else sys.stderr)

    def debug(self, msg: str, **f: Any) -> None:
        self.log("debug", msg, **f)

    def info(self, msg: str, **f: Any) -> None:
        self.log("info", msg, **f)

    def warn(self, msg: str, **f: Any) -> None:
        self.log("warn", msg, **f)

    def error(self, msg: str, **f: Any) -> None:
        self.log("error", msg, **f)

    # ----------------------------------------------------------------- spans
    def span(self, name: str, **fields: Any) -> "Span":
        return Span(self, name, fields)

    @contextlib.contextmanager
    def under(self, span: Optional["Span"]):
        """Adopt an open ``span`` as this thread's parent for the block.

        Span stacks are thread-local, so work fanned out to worker
        threads (the engine's wavefront scheduler) would otherwise log
        and trace its child spans rootless — ``module.x`` instead of
        ``apply/module.x``. No-op when ``span`` is None or already on
        this thread's stack (the serial inline path)."""
        stack = self._spans()
        if span is None or span in stack:
            yield
            return
        stack.append(span)
        try:
            yield
        finally:
            if stack and stack[-1] is span:
                stack.pop()
            elif span in stack:
                stack.remove(span)

    def _spans(self) -> List["Span"]:
        stack = getattr(self._span_stack, "stack", None)
        if stack is None:
            stack = []
            self._span_stack.stack = stack
        return stack


class Span:
    """A timed phase. Logs ``begin``/``end`` (with duration) at info level;
    failures log ``end`` at error level with the exception message, then
    re-raise. Nested spans appear as ``parent/child`` in JSON output."""

    def __init__(self, logger: Logger, name: str, fields: Dict[str, Any]):
        self.logger = logger
        self.name = name
        self.fields = fields
        self.t0 = 0.0
        self.t0_wall = 0.0
        self.duration_s: Optional[float] = None

    def __enter__(self) -> "Span":
        self.logger._spans().append(self)
        self.t0 = time.monotonic()
        self.t0_wall = time.time()
        self.logger.debug("begin", **self.fields)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # Unrounded monotonic duration: the trace export and the apply
        # journal must agree to the microsecond; the *log line* rounds.
        self.duration_s = time.monotonic() - self.t0
        try:
            if exc is None:
                self.logger.info("done",
                                 duration_s=round(self.duration_s, 3),
                                 **self.fields)
            else:
                self.logger.error("failed",
                                  duration_s=round(self.duration_s, 3),
                                  error=str(exc), **self.fields)
            if self.logger.trace is not None:
                path = "/".join(s.name for s in self.logger._spans())
                self.logger.trace.add_span(
                    self.name, path, self.t0_wall, self.duration_s,
                    self.fields, error=None if exc is None else str(exc))
        finally:
            stack = self.logger._spans()
            if stack and stack[-1] is self:
                stack.pop()


_default = Logger()


def configure(*, stream: Optional[TextIO] = None, json_mode: bool = False,
              level: str = "info",
              trace: Optional["TraceCollector"] = None) -> Logger:
    """Reconfigure the process-default logger (CLI startup)."""
    global _default
    _default = Logger(stream=stream, json_mode=json_mode, level=level,
                      trace=trace)
    return _default


def get_logger() -> Logger:
    return _default
