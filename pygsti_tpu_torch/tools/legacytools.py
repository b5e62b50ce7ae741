"""Deprecation helpers (counterpart of pygsti_tpu/tools/legacytools.py)."""

import functools as _functools
import types as _types
import warnings as _warnings

from pygsti_tpu_torch.tools.exceptions import pyGSTiDeprecationWarning


def warn_deprecated(name, replacement=None):
    """Emit a pyGSTiDeprecationWarning for `name`, suggesting `replacement`
    when given (reference legacytools.py:19)."""
    message = 'The function {} is deprecated'.format(name)
    if replacement is not None:
        message += ', and may be replaced with {}'.format(replacement)
    _warnings.warn(message, pyGSTiDeprecationWarning, stacklevel=3)


def deprecate(replacement=None):
    """Decorator marking a function deprecated (reference legacytools.py:42)."""
    def decorator(fn):
        @_functools.wraps(fn)
        def _inner(*args, **kwargs):
            warn_deprecated(fn.__name__, replacement)
            return fn(*args, **kwargs)
        return _inner
    return decorator


def deprecate_imports(module_name, replacement_map, warning_msg):
    """Replace `module_name` in sys.modules with a wrapper that warns when
    any name in `replacement_map` is accessed and calls the mapped no-arg
    factory to produce the replacement (reference legacytools.py:63,103 --
    map values are factories, not the replacements themselves)."""
    import sys

    module = sys.modules[module_name]

    class ModuleLookupWrapper(_types.ModuleType):
        def __getattribute__(self, name):
            if name in replacement_map:
                _warnings.warn(warning_msg.format(name=name),
                               pyGSTiDeprecationWarning, stacklevel=2)
                return replacement_map[name]()
            return module.__getattribute__(name)

    sys.modules[module_name] = ModuleLookupWrapper(module_name)
