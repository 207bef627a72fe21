"""Leveled stderr logging.

The port's own copy of ``stencil_tpu.utils.logging`` (reference:
include/stencil/logging.hpp:8-53). The level is read from the
``STENCIL_LOG_LEVEL`` environment variable (SPEW|DEBUG|INFO|WARN|ERROR|FATAL,
default INFO) and may be changed at runtime with :func:`set_level`.
``fatal`` raises instead of ``exit(1)`` so library users can handle errors.
The port runs one process per device, so the prefix carries no process index.
"""

from __future__ import annotations

import os
import sys

SPEW, DEBUG, INFO, WARN, ERROR, FATAL = 0, 1, 2, 3, 4, 5
_NAMES = {"SPEW": SPEW, "DEBUG": DEBUG, "INFO": INFO, "WARN": WARN, "ERROR": ERROR, "FATAL": FATAL}
_LEVEL = _NAMES.get(os.environ.get("STENCIL_LOG_LEVEL", "INFO").upper(), INFO)


class FatalError(RuntimeError):
    pass


def set_level(level) -> None:
    global _LEVEL
    _LEVEL = _NAMES[level.upper()] if isinstance(level, str) else int(level)


def get_level() -> int:
    return _LEVEL


def _emit(level: int, tag: str, msg: str) -> None:
    if level >= _LEVEL:
        print(f"[{tag}] " + str(msg), file=sys.stderr)


def spew(msg):
    _emit(SPEW, "SPEW", msg)


def debug(msg):
    _emit(DEBUG, "DEBUG", msg)


def info(msg):
    _emit(INFO, "INFO", msg)


def warn(msg):
    _emit(WARN, "WARN", msg)


def error(msg):
    _emit(ERROR, "ERROR", msg)


def fatal(msg):
    _emit(FATAL, "FATAL", msg)
    raise FatalError(str(msg))
