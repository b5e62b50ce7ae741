"""Shared argument-validation helpers (counterpart of
pygsti_tpu/tools/argchecks.py): a knob value an implementation does not
honor raises where the JAX package raises."""

from __future__ import annotations


def check_unsupported(fname, **given):
    """Raise NotImplementedError for explicitly-requested knob values an
    implementation does not honor -- no silent accept-and-ignore.  Each
    entry: name=(got, supported_value_or_tuple_of_values); a tuple-valued
    single option must be wrapped in an outer tuple."""
    for name, (got, ok) in given.items():
        ok_vals = ok if isinstance(ok, tuple) else (ok,)
        if got not in ok_vals:
            raise NotImplementedError(
                "%s: %s=%r is not supported (only %s)"
                % (fname, name, got,
                   " / ".join(repr(v) for v in ok_vals)))
