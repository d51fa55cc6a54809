"""Leveled structured logger for the library (quiet by default).

The port's copy of ``repro.obs.log``, rooted at ``repro_torch``. Library
code never calls ``print()``: it logs through ``get_logger(__name__)``
instead. By default nothing is emitted — the root ``repro_torch`` logger
carries only a ``NullHandler`` — so tier-1 test output and embedding
applications stay clean. Output is opt-in:

  * env: ``GESTORE_LOG=info`` (any standard level name; ``debug``,
    ``warning``, ...) attaches a stderr handler at that level for the
    whole process, or
  * code: CLI entry points call ``configure("info")`` so their
    human-facing progress lines still appear.

The format is one structured line per event:
``<unix-time> <LEVEL> <logger> <message>``.
"""
from __future__ import annotations

import logging
import os
import sys

_ROOT_NAME = "repro_torch"
_FORMAT = "%(created).3f %(levelname)s %(name)s %(message)s"
_configured = False


def get_logger(name: str | None = None) -> logging.Logger:
    """The library logger for ``name`` (dotted module path), rooted under
    the ``repro_torch`` namespace. Safe to call at import time."""
    root = logging.getLogger(_ROOT_NAME)
    if not root.handlers:
        root.addHandler(logging.NullHandler())
    env = os.environ.get("GESTORE_LOG")
    if env and not _configured:
        configure(env)
    if name is None or name == _ROOT_NAME:
        return root
    if name.startswith(_ROOT_NAME + "."):
        return logging.getLogger(name)
    return logging.getLogger(_ROOT_NAME + "." + name)


def configure(level: str | int = "info", *, stream=None) -> logging.Logger:
    """Attach (once) a stream handler to the ``repro_torch`` root at
    ``level``.

    Idempotent: repeat calls only adjust the level. CLI launchers call
    this so their progress output survives the quiet default; libraries
    never should."""
    global _configured
    root = logging.getLogger(_ROOT_NAME)
    lvl = (logging.getLevelName(level.upper()) if isinstance(level, str)
           else int(level))
    if not isinstance(lvl, int):
        lvl = logging.INFO
    if not _configured:
        h = logging.StreamHandler(stream or sys.stderr)
        h.setFormatter(logging.Formatter(_FORMAT))
        root.addHandler(h)
        _configured = True
    root.setLevel(lvl)
    return root
