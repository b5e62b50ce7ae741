"""MongoDB storage (counterpart of pygsti_tpu/io/mongodb.py).

The functions take a pymongo database or collection, or the in-memory mock
collection of baseobjs/mongoserializable.py (a dict of them for a
database); pymongo itself is not a dependency.  Documents hold the same JSON-codec states as the
meta.json directories.
"""

from __future__ import annotations

from pygsti_tpu_torch.baseobjs.mongoserializable import (MongoSerializable,  # noqa: F401
                                                         create_mongodb_collection)
from pygsti_tpu_torch.baseobjs.nicelyserializable import decode_value, encode_value
from pygsti_tpu_torch.serialization import decode_obj, encode_obj


def write_obj_to_mongodb_auxtree(obj, mongodb_collection, doc_id, auxfile_types_member=None,
                                 omit_attributes=(), include_attributes=None,
                                 additional_meta=None, session=None, overwrite_existing=False):
    """`obj`'s encoded state as the document `doc_id`; an existing one
    raises ValueError unless `overwrite_existing`."""
    doc = {'_id': doc_id, 'state': encode_obj(obj)}
    doc.update(additional_meta or {})
    if mongodb_collection.find_one({'_id': doc_id}, session=session) is not None:
        if not overwrite_existing:
            raise ValueError("Document %r already exists" % (doc_id,))
        mongodb_collection.delete_one({'_id': doc_id}, session=session)
    mongodb_collection.insert_one(doc, session=session)
    return doc_id


def read_auxtree_from_mongodb(mongodb_collection, doc_id, auxfile_types_member=None,
                              ignore_meta=('_id',), quick_load=False):
    """The object written by write_obj_to_mongodb_auxtree."""
    doc = mongodb_collection.find_one({'_id': doc_id})
    if doc is None:
        raise KeyError("No document with id %r" % (doc_id,))
    return decode_obj(doc['state'])


def remove_auxtree_from_mongodb(mongodb_collection, doc_id, session=None):
    mongodb_collection.delete_one({'_id': doc_id}, session=session)


def _member_query(doc_identifier, key=None):
    query = dict(doc_identifier) if isinstance(doc_identifier, dict) \
        else {'parent': doc_identifier}
    if key is not None:
        query['member_name'] = str(key)
    return query


def write_dict_to_mongodb(d, mongodb, collection_name, doc_identifier,
                          overwrite_existing=False, session=None):
    """Each entry of `d` as one document of the named collection."""
    coll = mongodb[collection_name]
    for key, val in d.items():
        doc_id = _member_query(doc_identifier, key)
        doc = dict(doc_id, value=encode_value(val))
        if overwrite_existing:
            coll.replace_one(doc_id, doc, upsert=True, session=session)
        else:
            coll.insert_one(doc, session=session)


def add_dict_to_mongodb_write_ops(d, write_ops, mongodb, collection_name, doc_identifier,
                                  overwrite_existing=False):
    """Append to `write_ops` the writes write_dict_to_mongodb would make."""
    for key, val in d.items():
        doc_id = {'parent': doc_identifier, 'member_name': str(key)}
        write_ops.append((collection_name, doc_id, dict(doc_id, value=encode_value(val)),
                          overwrite_existing))


def read_dict_from_mongodb(mongodb, collection_name, identifying_metadata):
    """The dict write_dict_to_mongodb wrote."""
    return {doc['member_name']: decode_value(doc['value'])
            for doc in mongodb[collection_name].find(_member_query(identifying_metadata))}


def remove_dict_from_mongodb(mongodb, collection_name, identifying_metadata, session=None):
    mongodb[collection_name].delete_many(_member_query(identifying_metadata), session=session)


def write_auxtree_to_mongodb(obj, mongodb, collection_name, doc_id,
                             auxfile_types_member='auxfile_types', omit_attributes=(),
                             include_attributes=None, additional_meta=None, session=None,
                             overwrite_existing=False):
    """write_obj_to_mongodb_auxtree into the named collection."""
    return write_obj_to_mongodb_auxtree(
        obj, mongodb[collection_name], doc_id, auxfile_types_member=auxfile_types_member,
        omit_attributes=omit_attributes, session=session)


def add_obj_auxtree_write_ops_and_update_doc(obj, doc, write_ops, mongodb, collection_name,
                                             doc_id, auxfile_types_member='auxfile_types',
                                             omit_attributes=(), include_attributes=None,
                                             additional_meta=None):
    """Put ``obj.__dict__`` (less `omit_attributes`, or only
    `include_attributes`) into `doc` and append its write to `write_ops`."""
    if include_attributes is not None:
        valuedict = {k: v for k, v in obj.__dict__.items() if k in include_attributes}
    else:
        valuedict = {k: v for k, v in obj.__dict__.items() if k not in omit_attributes}
    return add_auxtree_write_ops_and_update_doc(doc, write_ops, mongodb, collection_name,
                                                doc_id, valuedict, init_meta=additional_meta)


def add_auxtree_write_ops_and_update_doc(doc, write_ops, mongodb, collection_name, doc_id,
                                         valuedict, auxfile_types=None, init_meta=None):
    """Put `valuedict` into `doc` and append its write to `write_ops`."""
    doc.update(init_meta or {})
    doc['value'] = encode_value(dict(valuedict))
    write_ops.append((collection_name, doc_id, doc, True))
    return doc


def read_auxtree_from_mongodb_doc(mongodb, doc, auxfile_types_member='auxfile_types',
                                  ignore_meta=('_id', 'type'), separate_auxfiletypes=False,
                                  quick_load=False):
    """The value dict of a fetched document."""
    out = {k: v for k, v in doc.items() if k not in ignore_meta}
    if 'value' in out:
        out = decode_value(out['value'])
    if separate_auxfiletypes:
        return out, out.pop(auxfile_types_member, {})
    return out


def create_mongodb_indices_for_pygsti_collections(mongodb):
    """Indices on 'parent' and 'member_name' of the collections written."""
    for name in ('pygsti_experiment_designs', 'pygsti_data', 'pygsti_results', 'pygsti_dirs'):
        mongodb[name].create_index('parent')
        mongodb[name].create_index('member_name')
