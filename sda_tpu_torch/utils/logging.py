"""Structured logging for the framework.

The reference uses slog with a global scope logger and `-v` verbosity flags
(cli/src/main.rs:83-88, server-cli/src/lib.rs:29-36); the
HTTP layer logs request lines + error mappings. Python logging equivalents,
plus lightweight timing spans for the device pipeline (the reference had no
tracing at all — SURVEY.md §5 flags that gap; spans here feed the perf
reports in bench.py).
"""

from __future__ import annotations

import contextlib
import logging
import sys
import time

__all__ = ["get_logger", "setup", "span"]

_FORMAT = "%(asctime)s %(levelname).1s %(name)s %(message)s"


def setup(verbosity: int = 0, stream=None) -> None:
    """Map -v counts to levels like the reference CLIs (warn/info/debug)."""
    level = [logging.WARNING, logging.INFO, logging.DEBUG][min(verbosity, 2)]
    logging.basicConfig(level=level, format=_FORMAT, stream=stream or sys.stderr, force=True)


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(f"sda_tpu_torch.{name}")


@contextlib.contextmanager
def span(name: str, logger: logging.Logger | None = None):
    """Timing span: DEBUG-logs wall time of a pipeline stage."""
    log = logger or get_logger("span")
    t0 = time.perf_counter()
    try:
        yield
    finally:
        log.debug("%s took %.3f ms", name, (time.perf_counter() - t0) * 1e3)
