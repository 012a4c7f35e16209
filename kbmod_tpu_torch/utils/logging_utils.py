"""Unified logging configuration.

The reference bridges C++ and Python logging through a singleton registry
(src/kbmod/search/logging.h:12-29). kbmod_tpu has no C++ logging to bridge,
so ``Logging`` is a thin facade over the standard library that preserves the
same public surface (``Logging.getLogger``, shared format, level setting) and
the ``kbmod.*`` logger names that downstream code and tests rely on.
"""

import logging

_FORMAT = "[%(asctime)s %(levelname)s %(name)s] %(message)s"
_DATEFMT = "%Y-%m-%dT%H:%M:%SZ"


class Logging:
    """Compatibility facade for the reference's C++/Python logging singleton."""

    _configured = False

    @classmethod
    def _ensure_configured(cls):
        if not cls._configured:
            root = logging.getLogger("kbmod")
            if not root.handlers:
                handler = logging.StreamHandler()
                handler.setFormatter(logging.Formatter(_FORMAT, _DATEFMT))
                root.addHandler(handler)
                root.propagate = False
            cls._configured = True

    @classmethod
    def getLogger(cls, name=None):
        """Return a logger, mirroring ``logging.getLogger``."""
        cls._ensure_configured()
        return logging.getLogger(name)

    @classmethod
    def setLevel(cls, level, name="kbmod"):
        cls._ensure_configured()
        logging.getLogger(name).setLevel(level)
