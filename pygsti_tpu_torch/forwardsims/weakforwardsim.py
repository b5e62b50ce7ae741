"""Weak (shot-sampling) forward simulation and CHP program text
(counterpart of pygsti_tpu/forwardsims/weakforwardsim.py).

The port's symplectic tools are an Aaronson-Gottesman simulator, so the
"CHP" path samples outcomes on their stabilizer tableau (no external
binary) and can write a circuit as CHP program text.  Host numpy integer
algebra: each shot draws from its own RandomState(base_seed + shot), as in
the JAX package, and measures the circuit's final state, computed once per
circuit.
"""

from __future__ import annotations

import numpy as np

from pygsti_tpu_torch.baseobjs.outcomelabeldict import OutcomeLabelDict
from pygsti_tpu_torch.tools import symplectic as sym


def circuit_to_chp_program(circuit, pspec=None):
    """Serialize a Clifford circuit to CHP (Aaronson-Gottesman) program text:
    lines of 'h q' / 'p q' / 'c q1 q2' / 'm q' (reference: evotypes/chp/).

    Gates are compiled to the CHP primitive set {H, P, CNOT} via the
    symplectic compiler when they are not already primitives.
    """
    from pygsti_tpu_torch.algorithms.compilers import synthesize_symplectic
    qubits = list(circuit.line_labels)
    qidx = {q: i for i, q in enumerate(qubits)}
    lines = ['#', '']
    direct = {'Gh': 'h', 'Gp': 'p', 'Gcnot': 'c'}
    srep_dict = dict(sym.compute_internal_gate_symplectic_representations())
    if pspec is not None:
        srep_dict.update(pspec.compute_clifford_symplectic_reps())
    for i in range(circuit.depth):
        lbl = circuit.layertup[i]
        comps = lbl.components if not lbl.is_simple else (lbl,)
        for g in comps:
            if g.name in direct:
                qs = ' '.join(str(qidx[q]) for q in g.sslbls)
                lines.append('%s %s' % (direct[g.name], qs))
            else:
                # compile to H/P/CNOT generators
                if g.name not in srep_dict:
                    raise ValueError("Non-Clifford gate %s in CHP export"
                                     % g.name)
                s_g, p_g = srep_dict[g.name]
                gen_gates = synthesize_symplectic(s_g)
                for gen, local_qs in gen_gates:
                    mapped = [qidx[g.sslbls[lq]] for lq in local_qs]
                    if gen == 'CNOT':
                        lines.append('c %d %d' % (mapped[0], mapped[1]))
                    elif gen == 'H':
                        lines.append('h %d' % mapped[0])
                    elif gen == 'P':
                        lines.append('p %d' % mapped[0])
    for i in range(len(qubits)):
        lines.append('m %d' % i)
    return '\n'.join(lines) + '\n'


def sample_stabilizer_outcome(state_s, state_p, rand_state):
    """Sample one computational-basis outcome from a stabilizer state,
    measuring qubits in order with collapse."""
    n = len(state_p) // 2
    s, p = state_s, state_p
    bits = []
    for a in range(n):
        p0, st0, p1, st1 = sym.pauli_z_measurement(s, p, a)
        if p1 == 0.0 or (p0 > 0 and rand_state.uniform() < p0):
            bits.append(0)
            s, p = st0
        else:
            bits.append(1)
            s, p = st1
    return tuple(bits)


class WeakForwardSimulator(object):
    """Outcome probabilities as average frequencies over `shots` sampled
    runs (reference: weakforwardsim.py:20)."""

    def __init__(self, shots, model=None, base_seed=None):
        self.shots = shots
        self.model = model
        self.base_seed = base_seed if base_seed is not None else 2026

    def _compute_circuit_outcome_for_shot(self, circuit, rand_state,
                                          time=None):
        raise NotImplementedError

    def _shot_sampler(self, circuit, time=None):
        """A function rand_state -> one shot's outcome bits."""
        return lambda rng: self._compute_circuit_outcome_for_shot(circuit, rng, time)

    def probs(self, circuit, outcomes=None, time=None, clip_to=None):
        counts = {}
        sample = self._shot_sampler(circuit, time)
        for k in range(self.shots):
            out = sample(np.random.RandomState(self.base_seed + k))
            counts[out] = counts.get(out, 0) + 1
        keep = None if outcomes is None else \
            {OutcomeLabelDict.to_outcome(o) for o in outcomes}
        d = OutcomeLabelDict()
        for out, cnt in sorted(counts.items()):
            key = (''.join(map(str, out)),)
            if keep is not None and key not in keep:
                continue
            d[key] = cnt / self.shots
        if clip_to is not None:
            for k in d:
                d[k] = float(np.clip(d[k], clip_to[0], clip_to[1]))
        return d

    def bulk_probs(self, circuits, clip_to=None, resource_alloc=None,
                   smartc=None):
        return {c: self.probs(c, clip_to=clip_to) for c in circuits}


class CHPForwardSimulator(WeakForwardSimulator):
    """Weak simulator over the internal Aaronson-Gottesman tableau (the
    framework's CHP-equivalent backend; reference: evotypes/chp/ +
    weakforwardsim.py).  Also exports circuits as CHP program text."""

    def __init__(self, shots=100, model=None, base_seed=None, pspec=None):
        super().__init__(shots, model, base_seed)
        self.pspec = pspec

    def _final_state(self, circuit):
        """The noiseless output stabilizer state, on the circuit's own line
        labels with the pspec's gate definitions."""
        srep = dict(sym.compute_internal_gate_symplectic_representations())
        if self.pspec is not None:
            srep.update(self.pspec.compute_clifford_symplectic_reps())
        s_c, p_c = sym.symplectic_rep_of_clifford_circuit(circuit, srep_dict=srep)
        st = sym.prep_stabilizer_state(len(circuit.line_labels))
        return sym.apply_clifford_to_stabilizer_state(s_c, p_c, *st)

    def _shot_sampler(self, circuit, time=None):
        """Every shot measures the same final state, computed once."""
        out_s, out_p = self._final_state(circuit)
        return lambda rng: sample_stabilizer_outcome(out_s, out_p, rng)

    def _compute_circuit_outcome_for_shot(self, circuit, rand_state, time=None):
        return self._shot_sampler(circuit, time)(rand_state)

    def to_chp_program(self, circuit):
        return circuit_to_chp_program(circuit, self.pspec)
