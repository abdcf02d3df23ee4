"""Uniform structured logging for every edl_tpu_torch process.

Capability parity: the reference gives all of its services one root-logger
format ``[LEVEL time file:line]`` (reference python/edl/utils/utils.py:28-38).
Here each component asks for a named child logger instead of mutating the
root logger, so embedding applications keep control of their own logging.
"""

from __future__ import annotations

import logging
import os
import sys

_FORMAT = "[%(levelname)s %(asctime)s %(name)s %(filename)s:%(lineno)d] %(message)s"

_configured = False


def _configure_base() -> None:
    global _configured
    if _configured:
        return
    base = logging.getLogger("edl_tpu_torch")
    if not base.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        base.addHandler(handler)
    base.setLevel(os.environ.get("EDL_LOG_LEVEL", "INFO").upper())
    base.propagate = False
    _configured = True


def get_logger(name: str) -> logging.Logger:
    """Return the ``edl_tpu_torch.<name>`` logger, configuring the base once."""
    _configure_base()
    if name.startswith("edl_tpu_torch"):
        return logging.getLogger(name)
    return logging.getLogger("edl_tpu_torch." + name)
