"""Runtime logging for CLI / launch output (port of ``repro.obs.logs``).

All runtime text output of the port routes through here instead of bare
``print``: a ``repro_torch``-rooted ``logging`` tree with one stdout
handler, message-only formatting (CLI output looks exactly like the
prints it replaced), and an env override for verbosity::

    from repro_torch.obs import get_logger
    log = get_logger(__name__)
    log.info("[serve] decoded %d tokens", n)

``REPRO_LOG_LEVEL=DEBUG`` (or any level name) raises/lowers the tree's
threshold. Libraries embedding the port can detach the handler with
``logging.getLogger("repro_torch").handlers.clear()`` and route records into
their own stack — which a bare ``print`` never allows.
"""
from __future__ import annotations

import logging
import os
import sys
import threading

_ROOT = "repro_torch"
_lock = threading.Lock()
_configured = False


def _configure() -> None:
    global _configured
    with _lock:
        if _configured:
            return
        root = logging.getLogger(_ROOT)
        if not root.handlers:   # respect an embedding app's own setup
            handler = logging.StreamHandler(sys.stdout)
            handler.setFormatter(logging.Formatter("%(message)s"))
            root.addHandler(handler)
            root.propagate = False
        level = os.environ.get("REPRO_LOG_LEVEL", "INFO").upper()
        root.setLevel(getattr(logging, level, logging.INFO))
        _configured = True


def get_logger(name: str) -> logging.Logger:
    """A logger under the ``repro_torch`` tree (lazy one-time handler
    setup). ``name`` is typically ``__name__``; other names are nested
    under ``repro_torch.`` so the single handler covers them."""
    _configure()
    if name != _ROOT and not name.startswith(_ROOT + "."):
        name = f"{_ROOT}.{name}"
    return logging.getLogger(name)
