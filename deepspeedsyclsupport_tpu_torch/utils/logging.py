"""Logging utilities: the ``dstpu`` logger.

Port of ``deepspeedsyclsupport_tpu/utils/logging.py``'s logger: the same
name, format and ``DSTPU_LOG_LEVEL``.
"""
import logging
import os
import sys
from typing import Optional

LOG_FORMAT = "[%(asctime)s] [%(levelname)s] [%(name)s:%(lineno)d] %(message)s"


def _create_logger(name: str = "dstpu", level: Optional[int] = None) -> logging.Logger:
    lg = logging.getLogger(name)
    if lg.handlers:
        return lg
    level = level if level is not None else _env_level()
    lg.setLevel(level)
    lg.propagate = False
    handler = logging.StreamHandler(stream=sys.stdout)
    handler.setFormatter(logging.Formatter(LOG_FORMAT))
    lg.addHandler(handler)
    return lg


def _env_level() -> int:
    return getattr(logging, os.environ.get("DSTPU_LOG_LEVEL", "INFO").upper(), logging.INFO)


logger = _create_logger()
