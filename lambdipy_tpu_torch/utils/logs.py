"""Structured JSON logging, the twin of ``lambdipy_tpu/utils/logs.py``: one
JSON object per line on stderr (``LAMBDIPY_LOG_FORMAT=text`` for plain
lines, ``LAMBDIPY_LOG_LEVEL`` for the level)."""

from __future__ import annotations

import json
import logging
import os
import sys
import time


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        payload = {"ts": round(time.time(), 3),
                   "level": record.levelname.lower(),
                   "logger": record.name, "msg": record.getMessage()}
        extra = getattr(record, "data", None)
        if isinstance(extra, dict):
            payload.update(extra)
        return json.dumps(payload, default=str)


class _LiveStderrHandler(logging.StreamHandler):
    """Resolves ``sys.stderr`` when it emits, so a runner that swaps and
    closes ``sys.stderr`` between calls does not break later lines."""

    def __init__(self):
        logging.Handler.__init__(self)

    @property
    def stream(self):
        return sys.stderr

    @stream.setter
    def stream(self, value):  # StreamHandler's setter, unused
        pass


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = _LiveStderrHandler()
        if os.environ.get("LAMBDIPY_LOG_FORMAT", "json") == "json":
            handler.setFormatter(_JsonFormatter())
        else:
            handler.setFormatter(
                logging.Formatter("%(levelname)s %(name)s: %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(os.environ.get("LAMBDIPY_LOG_LEVEL", "INFO").upper())
        logger.propagate = False
    return logger


def log_event(logger: logging.Logger, msg: str, **data) -> None:
    logger.info(msg, extra={"data": data})
