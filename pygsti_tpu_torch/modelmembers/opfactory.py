"""Operation factories: families of operations indexed by the arguments of a
circuit label, such as the 0.347 of ``Gzr;0.347:0`` (counterpart of
pygsti_tpu/modelmembers/opfactory.py).

A factory maps label arguments to a concrete operation.  The operations it
creates are static (0-parameter) members, so they stack into a model's
tensors like any other leaf.
"""

from __future__ import annotations

import numpy as np

from pygsti_tpu_torch.modelmembers.modelmember import ModelMember
from pygsti_tpu_torch.modelmembers.operations import (ComposedOp, EmbeddedOp,
                                                      StaticArbitraryOp)
from pygsti_tpu_torch.tools import optools as _ot


class OpFactory(ModelMember):
    """Base class: subclasses implement ``create_object(args, sslbls)``."""

    def __init__(self, dim):
        super().__init__(np.empty(0))
        self._dim = dim

    def create_object(self, args=None, sslbls=None):
        raise NotImplementedError("Derived classes should implement this!")

    def create_op(self, args=None, sslbls=None):
        """The operation for the label arguments `args`."""
        return self.create_object(args, sslbls)


class UnitaryOpFactory(OpFactory):
    """The superoperator of the unitary ``fn(args)``."""

    def __init__(self, fn, udim, superop_basis='pp'):
        super().__init__(udim ** 2)
        self.fn = fn
        self.basis = superop_basis

    def create_object(self, args=None, sslbls=None):
        u = np.asarray(self.fn(args), complex)
        return StaticArbitraryOp(np.real(_ot.unitary_to_superop(u, self.basis)))


class EmbeddedOpFactory(OpFactory):
    """A factory whose operations are embedded on fixed `target_labels` of
    a larger state space."""

    def __init__(self, state_space, target_labels, factory_to_embed):
        self.state_space = state_space
        self.target_labels = tuple(target_labels)
        self.embedded_factory = factory_to_embed
        super().__init__(state_space.dim)

    def create_object(self, args=None, sslbls=None):
        return EmbeddedOp(self.state_space, self.target_labels,
                          self.embedded_factory.create_object(args, None))


class EmbeddingOpFactory(OpFactory):
    """A factory (or one operation) embedded on the target labels the
    circuit label names, not fixed at construction."""

    def __init__(self, state_space, factory_or_op_to_embed):
        self.state_space = state_space
        self.embedded = factory_or_op_to_embed
        super().__init__(state_space.dim)

    def create_object(self, args=None, sslbls=None):
        if sslbls is None:
            raise ValueError("EmbeddingOpFactory needs the layer label's state-space labels")
        op = self.embedded.create_object(args, None) if isinstance(self.embedded, OpFactory) \
            else self.embedded
        return EmbeddedOp(self.state_space, tuple(sslbls), op)


class ComposedOpFactory(OpFactory):
    """Composes fixed operations and the operations of factories, in
    circuit order (the first applied first)."""

    def __init__(self, factories_or_ops, dim=None):
        self.factors = list(factories_or_ops)
        super().__init__(dim if dim is not None else self.factors[0].dim)

    def create_object(self, args=None, sslbls=None):
        return ComposedOp([f.create_object(args, sslbls) if isinstance(f, OpFactory) else f
                           for f in self.factors])
