"""Model base classes: a flat parameter vector owned by the model, sliced by
its members (counterpart of pygsti_tpu/models/model.py).  The compute path is
a pure function ``tensors_fn()(v)`` from that vector to stacked tensors."""

from __future__ import annotations

import numpy as np

from pygsti_tpu_torch.baseobjs.basis import Basis
from pygsti_tpu_torch.baseobjs.nicelyserializable import NicelySerializable


class Model(NicelySerializable):
    """Base model: parameter-vector owner."""

    def __init__(self, dim):
        self._dim = int(dim)
        self._paramvec = np.empty(0)
        self._need_rebuild = True

    @property
    def dim(self):
        return self._dim

    @property
    def num_params(self):
        self._rebuild_paramvec_if_needed()
        return len(self._paramvec)

    def to_vector(self):
        self._rebuild_paramvec_if_needed()
        return self._paramvec.copy()

    def from_vector(self, v):
        self._rebuild_paramvec_if_needed()
        v = np.asarray(v, dtype=float)
        if len(v) != len(self._paramvec):
            raise ValueError("Wrong vector length: %d != %d"
                             % (len(v), len(self._paramvec)))
        self._paramvec = v.copy()
        self._push_paramvec_to_members()

    def _rebuild_paramvec_if_needed(self):
        if self._need_rebuild:
            self._rebuild_paramvec()
            self._need_rebuild = False

    def _mark_for_rebuild(self):
        self._need_rebuild = True


class OpModel(Model):
    """A model whose members are iterated in parameter-vector order."""

    def __init__(self, dim, basis='pp'):
        super().__init__(dim)
        self.basis = Basis.cast(basis, dim)

    def _iter_parameterized_objs(self):
        raise NotImplementedError()

    def _rebuild_paramvec(self):
        off = 0
        vecs = []
        for _, obj in self._iter_parameterized_objs():
            n = obj.num_params
            obj.gpindices = slice(off, off + n)
            vecs.append(obj.to_vector())
            off += n
        self._paramvec = np.concatenate(vecs) if vecs else np.empty(0)

    def _push_paramvec_to_members(self):
        for _, obj in self._iter_parameterized_objs():
            obj.from_vector(self._paramvec[obj.gpindices])
