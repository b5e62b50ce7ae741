"""UnitaryGateFunction: base for parameterized-unitary factories (counterpart
of pygsti_tpu/baseobjs/unitarygatefunction.py)."""

from __future__ import annotations


class UnitaryGateFunction(object):
    """A callable args -> unitary matrix, with a fixed shape attribute
    (reference: unitarygatefunction.UnitaryGateFunction).  Subclasses set
    `shape` and implement __call__; instances can be passed as gate
    'unitaries' to QubitProcessorSpec for continuously parameterized
    gates."""

    shape = None

    def __call__(self, arg):
        raise NotImplementedError("Subclasses should implement __call__")
