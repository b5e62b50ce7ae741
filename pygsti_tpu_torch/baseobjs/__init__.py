"""Base objects: labels, state spaces, bases, outcome dicts, qubit graphs,
serialization and printing (counterpart of pygsti_tpu/baseobjs)."""

from pygsti_tpu_torch.baseobjs.label import Label
from pygsti_tpu_torch.baseobjs.statespace import StateSpace, QubitSpace, ExplicitStateSpace
from pygsti_tpu_torch.baseobjs.basis import (Basis, BuiltinBasis, TensorProdBasis,
                                             DirectSumBasis)
from pygsti_tpu_torch.baseobjs.outcomelabeldict import OutcomeLabelDict
from pygsti_tpu_torch.baseobjs.qubitgraph import QubitGraph
from pygsti_tpu_torch.baseobjs.nicelyserializable import NicelySerializable
from pygsti_tpu_torch.baseobjs.verbosityprinter import VerbosityPrinter
