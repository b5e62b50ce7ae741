"""JSON codec for the port's objects (counterpart of
pygsti_tpu/serialization/jsoncodec.py).

The encoding is the JAX package's, so each package decodes the other's
output.  A ``__nice__`` state is rebuilt by the port's
``NicelySerializable.from_nice_serialization``, which reads a state that
names a ``pygsti_tpu.`` module as the port's module of the same path and
refuses any other module.  Unlike the JAX package, decoding a complex array
keeps its dtype (complex64 stays complex64).
"""

from __future__ import annotations

import json

import numpy as np

from pygsti_tpu_torch.baseobjs.nicelyserializable import (NicelySerializable, decode_value,
                                                          encode_value)


def encode_obj(obj, binary=False):
    """`obj` as JSON-compatible primitives with type tags."""
    if isinstance(obj, NicelySerializable):
        return {'__nice__': encode_value(obj.to_nice_serialization())}
    if isinstance(obj, np.ndarray):
        if np.iscomplexobj(obj):
            return {'__ndarray_c__': [obj.real.tolist(), obj.imag.tolist()],
                    'dtype': str(obj.dtype)}
        return {'__ndarray__': obj.tolist(), 'dtype': str(obj.dtype)}
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, complex):
        return {'__complex__': [obj.real, obj.imag]}
    if isinstance(obj, tuple):
        return {'__tuple__': [encode_obj(x, binary) for x in obj]}
    if isinstance(obj, list):
        return [encode_obj(x, binary) for x in obj]
    if isinstance(obj, dict):
        return {'__dict__': [[encode_obj(k, binary), encode_obj(v, binary)]
                             for k, v in obj.items()]}
    return obj


def decode_obj(obj, binary=False):
    """Inverse of encode_obj."""
    if isinstance(obj, dict):
        if '__nice__' in obj:
            return NicelySerializable.from_nice_serialization(decode_value(obj['__nice__']))
        if '__ndarray__' in obj:
            return np.array(obj['__ndarray__'], dtype=np.dtype(obj['dtype']))
        if '__ndarray_c__' in obj:
            re, im = obj['__ndarray_c__']
            return (np.array(re) + 1j * np.array(im)).astype(np.dtype(obj['dtype']))
        if '__complex__' in obj:
            return complex(obj['__complex__'][0], obj['__complex__'][1])
        if '__tuple__' in obj:
            return tuple(decode_obj(x, binary) for x in obj['__tuple__'])
        if '__dict__' in obj:
            return {decode_obj(k, binary): decode_obj(v, binary) for k, v in obj['__dict__']}
        return {k: decode_obj(v, binary) for k, v in obj.items()}
    if isinstance(obj, list):
        return [decode_obj(x, binary) for x in obj]
    return obj


def dumps(obj, **kwargs):
    return json.dumps(encode_obj(obj), **kwargs)


def loads(s, **kwargs):
    return decode_obj(json.loads(s, **kwargs))


def dump(obj, f, **kwargs):
    json.dump(encode_obj(obj), f, **kwargs)


def load(f, **kwargs):
    return decode_obj(json.load(f, **kwargs))
