"""Compilation rules of processor specs (counterpart of
pygsti_tpu/processors/compilationrules.py).  The rules class itself lives in
``algorithms/compilers.py`` (symplectic Clifford compilation onto native
gates); this module gives it the reference's module path."""

from __future__ import annotations

from pygsti_tpu_torch.algorithms.compilers import CompilationRules


class CompilationError(Exception):
    """Raised when a compilation cannot be found."""


class CliffordCompilationRules(CompilationRules):
    """Clifford-group compilation rules; 'absolute' and 'paulieq' compile
    types are both exact here."""

    @classmethod
    def create_standard(cls, processor_spec, compile_type="absolute",
                        what_to_compile=("1Qcliffords",), verbosity=0):
        if compile_type not in ("absolute", "paulieq"):
            raise ValueError("compile_type must be 'absolute' or 'paulieq'")
        return cls(processor_spec)
