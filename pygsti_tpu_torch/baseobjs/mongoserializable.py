"""MongoDB documents of nicely-serializable objects (counterpart of
pygsti_tpu/baseobjs/mongoserializable.py).

pymongo is not a dependency of the port.  A pymongo database or collection
works where one is passed in; without one, a dict-backed mock collection
gives the same write/read round trip in memory (a dict of them stands in
for a database).
"""

from __future__ import annotations


class _Result(object):
    def __init__(self, inserted_id):
        self.inserted_id = inserted_id


def _matches(doc, query):
    return all(doc.get(k) == v for k, v in query.items())


class _MockCollection(object):
    """Dict-backed stand-in for a pymongo collection."""

    def __init__(self):
        self._docs = {}
        self._next_id = 0

    def insert_one(self, doc, session=None):
        doc = dict(doc)
        if '_id' not in doc:
            doc['_id'] = self._next_id
            self._next_id += 1
        self._docs[doc['_id']] = doc
        return _Result(doc['_id'])

    def find(self, query=None, session=None):
        return [dict(d) for d in list(self._docs.values()) if _matches(d, query or {})]

    def find_one(self, query, session=None):
        if isinstance(query, dict):
            found = self.find(query)
            return found[0] if found else None
        return dict(self._docs[query]) if query in self._docs else None

    def replace_one(self, query, doc, upsert=False, session=None):
        found = self.find_one(query)
        if found is not None:
            doc = dict(doc)
            doc['_id'] = found['_id']
            self._docs[found['_id']] = doc
        elif upsert:
            self.insert_one(doc)

    def delete_one(self, query, session=None):
        found = self.find_one(query)
        if found is not None:
            del self._docs[found['_id']]

    def delete_many(self, query, session=None):
        for doc in self.find(query):
            del self._docs[doc['_id']]

    def create_index(self, keys, **kwargs):
        return keys


class MongoSerializable(object):
    """Mixin: objects whose nice serialization goes to and from one
    document of a collection."""

    collection_name = 'pygsti_objects'

    def write_to_mongodb(self, collection, doc_id=None, session=None,
                         overwrite_existing=False):
        doc = {'object_state': self.to_nice_serialization(), 'type': type(self).__name__}
        if doc_id is not None:
            doc['_id'] = doc_id
            if overwrite_existing:
                collection.replace_one({'_id': doc_id}, doc, upsert=True, session=session)
                return doc_id
        return collection.insert_one(doc, session=session).inserted_id

    @classmethod
    def from_mongodb(cls, collection, doc_id, session=None):
        from pygsti_tpu_torch.baseobjs.nicelyserializable import NicelySerializable
        doc = collection.find_one({'_id': doc_id}, session=session)
        if doc is None:
            raise KeyError("No document with id %r" % (doc_id,))
        return NicelySerializable.from_nice_serialization(doc['object_state'])


def create_mongodb_collection(db=None, collection_name='pygsti_objects'):
    """A collection to write to: ``db[collection_name]`` when a database is
    given, else an in-memory mock collection."""
    if db is not None:
        return db[collection_name]
    return _MockCollection()
