"""Circuit mirroring (reference: pygsti/algorithms/mirroring.py).

create_mirror_circuit builds C -> C + (random Pauli layer) + C^-1 for an
arbitrary Clifford circuit and returns the deterministic ideal outcome
bitstring (computed by symplectic simulation)."""

from __future__ import annotations

import numpy as np

from pygsti_tpu_torch.baseobjs.label import Label
from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.tools import symplectic as sym
from pygsti_tpu_torch.algorithms.compilers import CompilationRules, compile_1q_clifford


def create_mirror_circuit(circ, pspec, circ_type='clifford+zxzxz',
                          seed=None, rand_state=None):
    """Mirror of a Clifford circuit with central Pauli randomization
    (reference: mirroring.create_mirror_circuit:25).  Returns
    (mirror_circuit, ideal_outcome_bitstring)."""
    rng = rand_state if rand_state is not None else np.random.RandomState(seed)
    qubit_labels = tuple(circ.line_labels)
    n = len(qubit_labels)
    rules = CompilationRules(pspec)

    srep_dict = dict(sym.compute_internal_gate_symplectic_representations())
    srep_dict.update(pspec.compute_clifford_symplectic_reps())

    def invert_layer(layer):
        out = []
        comps = (layer,) if layer.is_simple else tuple(layer.components)
        for comp in comps:
            if len(comp) == 0:
                continue
            s_g, p_g = srep_dict[comp.name]
            s_i, p_i = sym.inverse_clifford(s_g, p_g)
            if comp.sslbls is not None and len(comp.sslbls) == 1:
                out.extend(compile_1q_clifford(s_i, p_i, rules.native_1q,
                                               comp.sslbls[0]))
            else:
                assert np.array_equal(s_i, s_g) and \
                    np.array_equal(p_i % 4, p_g % 4), \
                    "2Q gate %s is not self-inverse" % comp.name
                out.append(comp)
        return out

    layers = list(circ.layertup)
    mirror_layers = list(layers)
    # central random Pauli layer
    pauli_names = {(1, 0): 'Gxpi', (0, 1): 'Gzpi', (1, 1): 'Gypi'}
    for q in qubit_labels:
        xz = (rng.randint(2), rng.randint(2))
        nm = pauli_names.get(xz)
        if nm is not None:
            s1, p1 = srep_dict[nm]
            mirror_layers.extend(compile_1q_clifford(s1, p1, rules.native_1q, q))
    # inverse of the circuit, layers reversed
    for layer in reversed(layers):
        mirror_layers.extend(invert_layer(layer))

    mc = Circuit(tuple(mirror_layers), qubit_labels)
    # ideal outcome by symplectic propagation of |0...0>
    s_c, p_c = sym.symplectic_rep_of_clifford_circuit(mc, pspec=pspec)
    st = sym.prep_stabilizer_state(n)
    S, P = sym.apply_clifford_to_stabilizer_state(s_c, p_c, *st)
    bits = []
    for q in range(n):
        p0 = sym.pauli_z_measurement_probability(S, P, q)[0]
        bits.append('0' if p0 > 0.5 else ('1' if p0 < 0.5 else '?'))
    assert '?' not in bits, "mirror circuit output is not deterministic"
    return mc, ''.join(bits)
