"""Leveled logging printer (counterpart of
pygsti_tpu/baseobjs/verbosityprinter.py, trimmed to what the protocol layer
calls).  The port runs in one process, so nothing is filtered by rank."""

from __future__ import annotations

import sys


class VerbosityPrinter(object):
    """Prints messages at or below the configured verbosity level."""

    def __init__(self, verbosity=1, filename=None):
        self.verbosity = verbosity if verbosity is not None else 1
        self.filename = filename

    @classmethod
    def create_printer(cls, verbosity):
        if isinstance(verbosity, VerbosityPrinter):
            return verbosity
        return cls(verbosity)

    def _emit(self, msg):
        if self.filename:
            with open(self.filename, 'a') as f:
                f.write(msg + "\n")
        else:
            print(msg, file=sys.stdout)
            sys.stdout.flush()

    def log(self, message, message_level=1, indent_offset=0):
        if message_level <= self.verbosity:
            self._emit('  ' * indent_offset + str(message))

    def warning(self, message):
        self._emit("WARNING: %s" % message)
