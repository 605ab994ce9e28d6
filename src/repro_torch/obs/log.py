"""Structured logging for the repro_torch package — stdlib `logging`,
silent by default.

Library code logs through ``repro_torch.obs.log.get_logger(__name__)``;
the root ``"repro_torch"`` logger carries a `NullHandler`, so nothing is
emitted unless the *application* opts in.  `configure()` is that opt-in:
it attaches a plain ``%(message)s`` stdout handler (the default
formatter), under which the output is byte-for-byte what the same
``print(...)`` calls would write.
"""
from __future__ import annotations

import logging
import sys

ROOT = "repro_torch"

# library default: never emit unless the application configures a handler
logging.getLogger(ROOT).addHandler(logging.NullHandler())


def get_logger(name: str = None) -> logging.Logger:
    """A logger under the ``repro_torch`` hierarchy
    (``repro_torch.<name>``, or the root ``repro_torch`` logger when `name`
    is None).  Dotted module names that already start with
    ``repro_torch`` are used as-is."""
    if not name:
        return logging.getLogger(ROOT)
    if name == ROOT or name.startswith(ROOT + "."):
        return logging.getLogger(name)
    return logging.getLogger(ROOT + "." + name)


def configure(level: int = logging.INFO, stream=None,
              fmt: str = "%(message)s") -> logging.Logger:
    """Attach a stream handler to the ``repro_torch`` root (idempotent — the
    previous `configure` handler is replaced, not stacked).  The default
    ``%(message)s`` formatter writes what ``print`` of the message
    would, byte for byte."""
    root = logging.getLogger(ROOT)
    for h in list(root.handlers):
        if getattr(h, "_repro_obs_configured", False):
            root.removeHandler(h)
    handler = logging.StreamHandler(stream if stream is not None
                                    else sys.stdout)
    handler.setFormatter(logging.Formatter(fmt))
    handler._repro_obs_configured = True
    root.addHandler(handler)
    root.setLevel(level)
    return root
