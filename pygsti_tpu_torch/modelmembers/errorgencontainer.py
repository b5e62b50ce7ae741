"""Error-generator container mixins (counterpart of
pygsti_tpu/modelmembers/errorgencontainer.py).

The errorgen-coefficient API itself lives on the Lindblad members
(modelmembers/operations.py: LindbladErrorgen.errorgen_coefficients and
the members that wrap one); these classes give its names for isinstance
checks."""

from __future__ import annotations


class ErrorGeneratorContainer(object):
    """Marker/mixin: object exposing errorgen_coefficients() (reference:
    errorgencontainer.ErrorGeneratorContainer:18)."""

    def has_errorgen(self):
        return hasattr(self, 'errorgen_coefficients')


class ErrorMapContainer(ErrorGeneratorContainer):
    """Marker for error-MAP containers (reference:
    errorgencontainer.ErrorMapContainer:243)."""


class NoErrorGeneratorInterface(object):
    """Marker for members with no errorgen interface (reference:
    errorgencontainer.NoErrorGeneratorInterface:392)."""
