"""Model base classes: a flat parameter vector owned by the model, sliced by
its members (counterpart of pygsti_tpu/models/model.py).  The compute path is
a pure function ``tensors_fn()(v)`` from that vector to stacked tensors."""

from __future__ import annotations

import numpy as np
import torch

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

    def create_modelmember_graph(self):
        """The dependency graph of this model's members, for structural
        comparison by is_similar / is_equivalent."""
        from pygsti_tpu_torch.modelmembers.modelmembergraph import ModelMemberGraph
        return ModelMemberGraph.from_model(self)


class OpModel(Model):
    """A model whose members are iterated in parameter-vector order.

    With a ``param_interposer`` (a LinearInterposer, set by a FOGI
    reparameterization) the model's parameters v are not its members': the
    members hold w = M v, and the model vector of member values w is
    pinv(M) w."""

    param_interposer = None
    user_sim = None           # the simulator its user set, or None
    _default_sim = None
    _sim_type = 'auto'

    def __init__(self, dim, basis='pp', simulator='auto'):
        super().__init__(dim)
        self.basis = Basis.cast(basis, dim)
        self._set_simulator(simulator)

    # -- the simulator (the JAX package's Model.sim) ----------------------------
    def _set_simulator(self, simulator):
        """`simulator` is a type name ('auto', 'map', 'matrix', 'dense': the
        default simulator) or a ForwardSimulator, which becomes the
        model's own."""
        from pygsti_tpu_torch.forwardsims.forwardsim import SIM_TYPES, ForwardSimulator
        if isinstance(simulator, ForwardSimulator):
            self.sim = simulator
        elif simulator in SIM_TYPES:
            self._sim_type = simulator
        else:
            raise ValueError("Unknown simulator type %r" % (simulator,))

    @property
    def sim(self):
        """The model's simulator: the one set (``model.sim = ...`` or
        ``simulator=``), else a SimpleForwardSimulator on "cuda", made once.
        Objectives take the one set; without it they build their own on
        their device."""
        if self.user_sim is not None:
            return self.user_sim
        if self._default_sim is None:
            from pygsti_tpu_torch.forwardsims.forwardsim import create_forward_simulator
            self._default_sim = create_forward_simulator(self._sim_type, self)
        return self._default_sim

    @sim.setter
    def sim(self, new_sim):
        new_sim.model = self
        self.user_sim = new_sim

    def _copy_simulator_to(self, m):
        """Give the copy `m` a fresh simulator of this model's type and
        settings."""
        m._sim_type = self._sim_type
        if self.user_sim is not None:
            m.sim = self.user_sim.fresh(m)

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
        w = np.concatenate(vecs) if vecs else np.empty(0)
        ip = self.param_interposer
        self._paramvec = w if ip is None else ip.ops_paramvec_to_model_paramvec(w)

    def _push_paramvec_to_members(self):
        ip = self.param_interposer
        w = self._paramvec if ip is None else ip.model_paramvec_to_ops_paramvec(self._paramvec)
        for _, obj in self._iter_parameterized_objs():
            obj.from_vector(w[obj.gpindices])

    @property
    def num_member_params(self):
        """The members' parameter count: num_params unless an interposer
        maps the model's parameters to theirs."""
        self._rebuild_paramvec_if_needed()
        ip = self.param_interposer
        return len(self._paramvec) if ip is None else ip.num_op_params

    def _interposer_matrix(self):
        """None without an interposer; else a function v -> M as a tensor
        on v's device and dtype (made once per device and dtype)."""
        ip = self.param_interposer
        if ip is None:
            return None
        consts = {}

        def matrix(v):
            key = (str(v.device), v.dtype)
            if key not in consts:
                consts[key] = torch.as_tensor(ip.transform_matrix, dtype=v.dtype, device=v.device)
            return consts[key]

        return matrix

    def _interposed(self, member_fn):
        """member_fn(w, t) as a function of the model vector v, w = M v;
        member_fn itself without an interposer."""
        M = self._interposer_matrix()
        if M is None:
            return member_fn
        return lambda v, t=None: member_fn(M(v) @ v, t)
