"""JSON-dict round-trip serialization base class (counterpart of
pygsti_tpu/baseobjs/nicelyserializable.py).

Objects write a state dict with a 'module'/'class' pair and reload by
importing that module.  The port writes its own module names.  On reading, a
state whose module lies under ``pygsti_tpu.`` (written by the JAX package)
is resolved to the same path under ``pygsti_tpu_torch.`` -- a rewrite of the
string, the JAX package is never imported -- so a checkpoint the JAX package
wrote resumes here.  Modules outside the port are refused.
"""

from __future__ import annotations

import importlib
import json

import numpy as np

_OWN_PREFIX = 'pygsti_tpu_torch.'
_JAX_PREFIX = 'pygsti_tpu.'


def _encode_value(v):
    if isinstance(v, np.ndarray):
        if np.iscomplexobj(v):
            return {'__ndarray_complex__': True, 'real': v.real.tolist(),
                    'imag': v.imag.tolist(), 'dtype': str(v.real.dtype)}
        return {'__ndarray__': True, 'data': v.tolist(), 'dtype': str(v.dtype)}
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, dict):
        return {k: _encode_value(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        enc = [_encode_value(x) for x in v]
        return {'__tuple__': True, 'items': enc} if isinstance(v, tuple) else enc
    return v


def _decode_value(v):
    if isinstance(v, dict):
        if v.get('__ndarray__'):
            return np.array(v['data'], dtype=v['dtype'])
        if v.get('__ndarray_complex__'):
            return np.array(v['real'], dtype=v['dtype']) + 1j * np.array(v['imag'], dtype=v['dtype'])
        if v.get('__tuple__'):
            return tuple(_decode_value(x) for x in v['items'])
        return {k: _decode_value(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_decode_value(x) for x in v]
    return v


def resolve_module_name(module):
    """The port's module for a state's 'module' entry."""
    if module.startswith(_JAX_PREFIX):
        module = _OWN_PREFIX + module[len(_JAX_PREFIX):]
    if not module.startswith(_OWN_PREFIX):
        raise ValueError("Refusing to load a state of module %r: not a module "
                         "of pygsti_tpu_torch" % module)
    return module


class NicelySerializable(object):
    """Base class providing to/from nice-serialization (JSON-able dicts)."""

    def to_nice_serialization(self):
        state = self._to_nice_serialization()
        state['module'] = type(self).__module__
        state['class'] = type(self).__name__
        return state

    @classmethod
    def from_nice_serialization(cls, state):
        mod = importlib.import_module(resolve_module_name(state['module']))
        klass = getattr(mod, state['class'])
        # some classes override the public method directly instead of the
        # underscore hook; dispatch to whichever the class provides
        base_fn = NicelySerializable.from_nice_serialization.__func__
        if getattr(klass.from_nice_serialization, '__func__', None) is not base_fn:
            return klass.from_nice_serialization(state)
        return klass._from_nice_serialization(state)

    def _to_nice_serialization(self):
        return {}

    @classmethod
    def _from_nice_serialization(cls, state):
        raise NotImplementedError("%s does not implement _from_nice_serialization" % cls.__name__)

    # -- json file helpers --------------------------------------------------
    def write(self, path):
        with open(path, 'w') as f:
            json.dump(_encode_value(self.to_nice_serialization()), f, indent=1)

    @classmethod
    def read(cls, path):
        with open(path) as f:
            state = _decode_value(json.load(f))
        return cls.from_nice_serialization(state)

    def dumps(self):
        return json.dumps(_encode_value(self.to_nice_serialization()))

    @classmethod
    def loads(cls, s):
        return cls.from_nice_serialization(_decode_value(json.loads(s)))


encode_value = _encode_value
decode_value = _decode_value
