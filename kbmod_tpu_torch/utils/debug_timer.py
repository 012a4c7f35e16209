"""A wall-clock phase timer that logs start/stop at debug level.

Behavior-compatible with the reference's C++ DebugTimer
(src/kbmod/search/debug_timer.cpp:13-54): construction starts the timer,
``stop()`` logs the elapsed time, ``read()`` returns elapsed seconds, and
``start()`` restarts it.
"""

import logging
import time


class DebugTimer:
    def __init__(self, name, logger=None):
        self.name = name
        if logger is None:
            logger = logging.getLogger("kbmod.timer")
        elif isinstance(logger, str):
            logger = logging.getLogger(logger)
        self.logger = logger
        self._running = False
        self._t_start = 0.0
        self._elapsed = 0.0
        self.start()

    def start(self):
        """Start (or restart) the timer."""
        self._running = True
        self._t_start = time.perf_counter()
        self.logger.debug(f"Timer {self.name} started.")

    def stop(self):
        """Stop the timer and log the elapsed time."""
        if self._running:
            self._elapsed = time.perf_counter() - self._t_start
            self._running = False
            self.logger.debug(f"Timer {self.name} ended in {self._elapsed:.5f} seconds.")

    def read(self):
        """Return the elapsed time in seconds (without stopping)."""
        if self._running:
            return time.perf_counter() - self._t_start
        return self._elapsed
