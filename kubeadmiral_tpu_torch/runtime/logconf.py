"""Structured logging for the ``kubeadmiral.*`` logger tree.

Every module logs through a ``kubeadmiral.<component>`` logger
(engine, streaming, dispatch, worker, transport, manager, ...).  This
module owns the one process-wide handler configuration:

* ``LEVEL`` — level for the ``kubeadmiral`` tree (DEBUG, INFO,
  WARNING, ...; default WARNING, so steady-state operation is silent).
  DEBUG turns on the per-tick engine lines (tick id, stage split) and
  per-flush streaming lines (flush id, engine tick).
* ``JSON_LINES`` — True emits one JSON object per line (ts, level,
  logger, msg, tick/span correlation) instead of the text format; the
  shape log aggregators ingest directly.

The JAX module reads these from ``KT_LOG_LEVEL`` / ``KT_LOG_JSON``;
here they are module constants with its defaults, and
``setup_logging``'s arguments override them.

Records carry a ``span`` attribute — the id of the innermost open
trace span on the emitting thread (runtime/trace.py) — so a log line
can be joined against ``/debug/trace`` output; engine/streaming lines
additionally embed their tick/flush ids in the message
(``tick=<id>``), the same ids ``/debug/waterfall`` keys on.

``setup_logging()`` is idempotent and is called by the controller
manager at start and by ``python -m kubeadmiral_tpu_torch``; embedders that
own their logging config simply never call it (module loggers then
propagate to whatever the host app configured).  See
docs/operations.md.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Optional

ROOT_LOGGER = "kubeadmiral"

# The tree's level and line format when setup_logging() is given none.
LEVEL = "WARNING"
JSON_LINES = False

_configured = False


class SpanContextFilter(logging.Filter):
    """Attach the innermost open trace-span id (this thread) to every
    record, so text and JSON lines both carry the /debug/trace join
    key."""

    def filter(self, record: logging.LogRecord) -> bool:
        try:
            from kubeadmiral_tpu_torch.runtime import trace

            span = trace.get_default().current()
            record.span = span.span_id if span is not None else "-"
        except Exception:
            record.span = "-"
        return True


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        doc = {
            "ts": round(time.time(), 3),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
            "span": getattr(record, "span", "-"),
            "thread": record.threadName,
        }
        if record.exc_info:
            doc["exc"] = self.formatException(record.exc_info)
        return json.dumps(doc)


TEXT_FORMAT = (
    "%(asctime)s %(levelname)-7s %(name)s span=%(span)s %(message)s"
)


def setup_logging(
    level: Optional[str] = None,
    json_lines: Optional[bool] = None,
    stream=None,
    force: bool = False,
) -> logging.Logger:
    """Configure the ``kubeadmiral`` logger tree from LEVEL and
    JSON_LINES (arguments override them; ``force=True`` reconfigures an
    already-configured tree — tests use it).  Returns the tree root."""
    global _configured
    logger = logging.getLogger(ROOT_LOGGER)
    if _configured and not force:
        return logger
    if level is None:
        level = LEVEL
    if json_lines is None:
        json_lines = JSON_LINES
    resolved = getattr(logging, str(level).upper(), None)
    if not isinstance(resolved, int):
        resolved = logging.WARNING
    for h in list(logger.handlers):
        logger.removeHandler(h)
    handler = logging.StreamHandler(stream if stream is not None else sys.stderr)
    handler.addFilter(SpanContextFilter())
    handler.setFormatter(
        JsonFormatter() if json_lines else logging.Formatter(TEXT_FORMAT)
    )
    logger.addHandler(handler)
    logger.setLevel(resolved)
    # Propagation stays ON: pytest's caplog and embedder root handlers
    # capture through the root logger; the cost is a duplicate line
    # when BOTH this handler and a root handler exist, which only a
    # host app that also calls basicConfig() would see.
    _configured = True
    return logger
