"""Processor specifications and compilation rules (counterpart of
pygsti_tpu/processors)."""

from pygsti_tpu_torch.processors.processorspec import QubitProcessorSpec
from pygsti_tpu_torch.processors.compilationrules import (CompilationRules,
                                                          CliffordCompilationRules,
                                                          CompilationError)
from pygsti_tpu_torch.processors.random_compilation import pauli_randomize_circuit
