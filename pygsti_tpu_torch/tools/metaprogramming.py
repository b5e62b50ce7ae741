"""Metaprogramming helpers (counterpart of
pygsti_tpu/tools/metaprogramming.py)."""


def set_docstring(docstring):
    """Decorator assigning `docstring` as the wrapped object's __doc__."""
    def decorator(obj):
        obj.__doc__ = docstring
        return obj
    return decorator
