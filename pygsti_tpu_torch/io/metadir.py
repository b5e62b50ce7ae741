"""meta.json directories (counterpart of pygsti_tpu/io/metadir.py).

An object's state goes to `dirname`/meta.json through the JSON codec, with
its class under 'type'.  Reading a class name back goes through
``resolve_module_name``, as the nice serialization does: a ``pygsti_tpu.``
module is read as the port's module of the same path, and a module outside
the port is refused rather than imported (the JAX package imports whatever
module a meta.json names).
"""

from __future__ import annotations

import importlib
import json
import os
import pathlib
import pickle

from pygsti_tpu_torch.baseobjs.nicelyserializable import resolve_module_name


def _full_class_name(obj):
    return type(obj).__module__ + "." + type(obj).__name__


def _class_for_name(name):
    mod, cls = name.rsplit(".", 1)
    return getattr(importlib.import_module(resolve_module_name(mod)), cls)


def write_meta_based_dir(root_dir, valuedict, auxfile_types=None, init_meta=None):
    """`valuedict` (and `init_meta`) encoded into `root_dir`/meta.json."""
    from pygsti_tpu_torch.serialization import encode_obj
    root = pathlib.Path(root_dir)
    root.mkdir(parents=True, exist_ok=True)
    meta = dict(init_meta or {})
    meta.update({k: encode_obj(v) for k, v in valuedict.items()})
    with open(root / "meta.json", "w") as f:
        json.dump(meta, f, indent=1)


def load_meta_based_dir(root_dir, auxfile_types_member='auxfile_types', ignore_meta=('type',),
                        separate_auxfiletypes=False):
    """The decoded entries of `root_dir`/meta.json, less `ignore_meta`."""
    from pygsti_tpu_torch.serialization import decode_obj
    with open(pathlib.Path(root_dir) / "meta.json") as f:
        meta = json.load(f)
    out = {k: decode_obj(v) for k, v in meta.items() if k not in (ignore_meta or ())}
    return (out, {}) if separate_auxfiletypes else out


def _cls_from_meta_json(dirname):
    """The class a directory's meta.json names under 'type'."""
    with open(pathlib.Path(dirname) / "meta.json") as f:
        return _class_for_name(json.load(f)['type'])


def write_obj_to_meta_based_dir(obj, dirname, auxfile_types_member, omit_attributes=(),
                                include_attributes=None, additional_meta=None):
    """``obj.__dict__`` (less `omit_attributes`, or only
    `include_attributes`) and the object's class into `dirname`/meta.json."""
    if include_attributes is not None:
        valuedict = {k: v for k, v in obj.__dict__.items() if k in include_attributes}
    else:
        valuedict = {k: v for k, v in obj.__dict__.items() if k not in omit_attributes}
    auxtypes = getattr(obj, auxfile_types_member, None) if auxfile_types_member else None
    valuedict['type'] = _full_class_name(obj)
    valuedict.update(additional_meta or {})
    write_meta_based_dir(dirname, valuedict, auxfile_types=auxtypes)


def write_dict_to_json_or_pkl_files(d, dirname):
    """Each entry of `d` into its own file under `dirname`: <key>.json when
    it is JSON-able, else <key>.pkl."""
    os.makedirs(str(dirname), exist_ok=True)
    for key, val in d.items():
        try:
            s = json.dumps(val, indent=1)
        except TypeError:
            with open(os.path.join(str(dirname), '%s.pkl' % key), 'wb') as f:
                pickle.dump(val, f)
            continue
        with open(os.path.join(str(dirname), '%s.json' % key), 'w') as f:
            f.write(s)
