"""Compilation rules of processor specs (counterpart of
pygsti_tpu/processors/compilationrules.py and the rules class of
pygsti_tpu/algorithms/compilers.py).  What the rules know of the processor
is ported; compiling a one-qubit Clifford onto native gates needs the
symplectic tools, which are not ported yet, and raises."""

from __future__ import annotations

from pygsti_tpu_torch.baseobjs.label import Label


class CompilationError(Exception):
    """Raised when a compilation cannot be found."""


class CompilationRules(object):
    """Maps the abstract generators (H, P, CNOT, Paulis) to circuits of a
    processor's native gates."""

    def __init__(self, pspec, one_q_gate_names=None):
        self.pspec = pspec
        if one_q_gate_names is None:
            one_q_gate_names = [g for g in pspec.gate_names if g not in ('{idle}', '(idle)')
                                and pspec.gate_num_qubits(g) == 1]
        self.native_1q = tuple(one_q_gate_names)
        self.has_cnot = 'Gcnot' in pspec.gate_names
        self.has_cphase = 'Gcphase' in pspec.gate_names or 'Gcz' in pspec.gate_names

    def word_for_1q(self, gen_name, qubit):
        raise NotImplementedError("compiling one-qubit Cliffords needs tools/symplectic.py, "
                                  "which is not ported yet (ROADMAP.md, queue 1)")

    def word_for_cnot(self, control, target):
        if self.has_cnot:
            return [Label('Gcnot', (control, target))]
        if self.has_cphase:
            h = self.word_for_1q('H', target)
            return h + [Label('Gcphase', (control, target))] + h
        raise ValueError("Processor has no 2-qubit gate for CNOT compilation")


class CliffordCompilationRules(CompilationRules):
    """Clifford-group compilation rules; 'absolute' and 'paulieq' compile
    types are both exact here."""

    @classmethod
    def create_standard(cls, processor_spec, compile_type="absolute",
                        what_to_compile=("1Qcliffords",), verbosity=0):
        if compile_type not in ("absolute", "paulieq"):
            raise ValueError("compile_type must be 'absolute' or 'paulieq'")
        return cls(processor_spec)
