"""JSON serialization of the port's objects (counterpart of
pygsti_tpu/serialization): NicelySerializable objects go through their own
state dicts; numpy arrays, complex numbers, tuples and dicts with any keys
carry type tags, so decoding gives back what was encoded."""

from pygsti_tpu_torch.serialization.jsoncodec import (encode_obj, decode_obj, dumps, loads,
                                                      dump, load)
