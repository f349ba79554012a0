"""Structured logging (port of ocrjax/utils/logging.py).

Plain stdlib logging with an optional JSON formatter: `log_fields` attaches
key=value fields to a record, which JsonFormatter merges into its object
and TextFormatter appends as k=v pairs. The CLI's --json flag covers
machine-readable results; this covers operational logs.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Optional


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(time.time(), 3),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        extra = getattr(record, "fields", None)
        if extra:
            out.update(extra)
        return json.dumps(out)


class TextFormatter(logging.Formatter):
    """Human format that still shows log_fields' key=value pairs."""

    def format(self, record: logging.LogRecord) -> str:
        base = super().format(record)
        extra = getattr(record, "fields", None)
        if extra:
            base += " " + " ".join(f"{k}={v}" for k, v in extra.items())
        return base


def get_logger(name: str = "ocrjax_torch", json_logs: bool = False,
               level: int = logging.INFO,
               stream=None) -> logging.Logger:
    """The named logger; on first use it gets a stream handler (stderr by
    default) with the JSON or the text formatter, `level`, and no
    propagation to the root logger."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(stream or sys.stderr)
        h.setFormatter(
            JsonFormatter() if json_logs
            else TextFormatter("%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s"))
        logger.addHandler(h)
        logger.setLevel(level)
        logger.propagate = False
    return logger


def log_fields(logger: logging.Logger, level_or_msg: str,
               msg: Optional[str] = None, **fields) -> None:
    """Structured key=value logging that survives the JSON formatter.

    log_fields(logger, "msg", k=v)            - INFO
    log_fields(logger, "warning", "msg", k=v) - explicit level
    """
    if msg is None:
        level, msg = "info", level_or_msg
    else:
        level = level_or_msg
    getattr(logger, level)(msg, extra={"fields": fields})
