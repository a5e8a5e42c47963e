"""Structured logging and tracing spans for the framework.

The reference uses slog with a global scope logger and `-v` verbosity flags
(cli/src/main.rs:83-88, server-cli/src/lib.rs:29-36); the
HTTP layer logs request lines + error mappings. Python logging equivalents
here, plus :func:`span`, the port's one tracing helper (the reference had no
tracing at all — SURVEY.md §5 flags that gap): named ranges in a
``torch.profiler`` trace, on the clock of the card's activities.
"""

from __future__ import annotations

import contextlib
import logging
import sys

__all__ = ["get_logger", "setup", "span"]

_FORMAT = "%(asctime)s %(levelname).1s %(name)s %(message)s"
_OFF = contextlib.nullcontext()


def setup(verbosity: int = 0, stream=None) -> None:
    """Map -v counts to levels like the reference CLIs (warn/info/debug)."""
    level = [logging.WARNING, logging.INFO, logging.DEBUG][min(verbosity, 2)]
    logging.basicConfig(level=level, format=_FORMAT, stream=stream or sys.stderr, force=True)


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(f"sda_tpu_torch.{name}")


def span(name: str):
    """A context naming one phase of the program, ``sda.<module>.<phase>``.

    While a ``torch.profiler`` session records, it is a
    ``record_function`` range: the trace holds it on the clock of the
    card's activities, inside the range that encloses it on the thread.
    Otherwise it is one shared no-op context. A span never synchronizes: it
    times the host's part, and the card's part is read from the trace;
    where the host waits on the card, the program's own blocking call sits
    in a span named ``*.wait``."""
    # no torch imported: no session can be recording (the host plane
    # imports this module without torch)
    profiler = sys.modules.get("torch.autograd.profiler")
    if profiler is None or not profiler._is_profiler_enabled:
        return _OFF
    return profiler.record_function(name)
