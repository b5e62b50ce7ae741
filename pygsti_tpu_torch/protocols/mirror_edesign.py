"""Mirror-circuit fidelity-estimation experiment designs (counterpart of
pygsti_tpu/protocols/mirror_edesign.py; arXiv:2204.07568).

Builds, for each test circuit T on the u3-cx-cz gate set, the three
randomized mirror-circuit families used by MCFE:
  'br'  : L + T + T^-1 + L^-1 with the reverse half randomized (M1)
  'rr'  : L + R + R^-1 + L^-1 fully randomized (M2)
  'ref' : L + L^-1 randomized (SPAM reference, M3)
or, with the 'central_pauli' strategy, 'cp'/'cpref' families.

The per-circuit aux info records the target bitstring; because Pauli-frame
randomization is an operator identity, the bitstring returned by randomizing
only the reverse half is valid for the full mirror circuit.  Host numpy;
without `rand_state` the draws come from an unseeded RandomState, as in the
JAX package.
"""

from __future__ import annotations

import collections

import numpy as np

from pygsti_tpu_torch.baseobjs.label import Label
from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.protocols.protocol import (CombinedExperimentDesign,
                                           FreeformDesign)
from pygsti_tpu_torch.processors import random_compilation as _rc


def compute_inverse(circ, gate_set='u3_cx_cz', inverse=None, inv_kwargs=None):
    """Layer-reversed inverse of a u3-cx-cz circuit (reference:
    mirror_edesign.py:889)."""
    if inverse is not None:
        return inverse(circ=circ, **(inv_kwargs or {}))
    assert gate_set == 'u3_cx_cz', "only the u3_cx_cz gate set is built in"
    layers = []
    for i in range(circ.depth - 1, -1, -1):
        lbl = circ.layertup[i]
        comps = lbl.components if not lbl.is_simple else (lbl,)
        new = []
        for g in comps:
            if g.name == 'Gu3':
                new.append(Label('Gu3', g.sslbls,
                                 args=_rc.inverse_u3(g.args)))
            elif g.name in ('Gcnot', 'Gcphase', 'Gcz', 'Gi', 'Gdelay'):
                new.append(g)      # self-inverse / idle
            else:
                raise ValueError("Cannot invert gate %s" % g.name)
        layers.append(new)
    return Circuit(layers, circ.line_labels)


def haar_random_u3(q, rand_state):
    """A Haar-random 1-qubit gate as a Gu3 label (reference:
    mirror_edesign.py / random_compilation.py:557)."""
    # Haar measure: theta ~ 2*asin(sqrt(U(0,1))), phi & lam uniform
    theta = 2 * np.arcsin(np.sqrt(rand_state.uniform(0, 1)))
    phi = rand_state.uniform(-np.pi, np.pi)
    lam = rand_state.uniform(-np.pi, np.pi)
    return Label('Gu3', (q,), args=(theta, phi, lam))


def init_layer(qubits, gate_set='u3_cx_cz', state_initialization=None,
               state_init_kwargs=None, rand_state=None):
    """Random state-initialization layer (reference: mirror_edesign.py:934)."""
    rng = rand_state if rand_state is not None else np.random.RandomState()
    if state_initialization == 'none':
        return Circuit([], tuple(qubits))
    if callable(state_initialization):
        return state_initialization(qubits=qubits, rand_state=rng,
                                    **(state_init_kwargs or {}))
    return Circuit([[haar_random_u3(q, rng) for q in qubits]], tuple(qubits))


def make_mirror_edesign(test_edesign, num_mcs_per_circ=10,
                        mirroring_strategy='pauli_rc', gate_set='u3_cx_cz',
                        inverse=None, inv_kwargs=None, rc_function=None,
                        rc_kwargs=None, state_initialization=None,
                        state_init_kwargs=None, rand_state=None,
                        ref_edesign=None):
    """Build the MCFE mirror-circuit families for every circuit of
    `test_edesign` (a FreeformDesign or circuit list) (reference:
    mirror_edesign.py:620)."""
    rng = rand_state if rand_state is not None else np.random.RandomState()
    if not isinstance(test_edesign, FreeformDesign):
        test_edesign = FreeformDesign(list(test_edesign))

    def rc(circ):
        if rc_function is not None:
            return rc_function(circ=circ, rand_state=rng, **(rc_kwargs or {}))
        out = _rc.pauli_randomize_circuit(circ, rng, return_bs=True)
        return out[0], out[1]

    test_ref_invs = collections.OrderedDict()
    ref_ref_invs = collections.OrderedDict()
    spam_refs = collections.OrderedDict()

    for T, aux in test_edesign.aux_info.items():
        qubits = T.line_labels
        R = T
        R_inv = compute_inverse(R, gate_set, inverse, inv_kwargs)
        T_for_concat = Circuit(list(T.layertup), qubits)

        for j in range(num_mcs_per_circ):
            L_br = init_layer(qubits, gate_set, state_initialization,
                              state_init_kwargs, rng)
            L_rr = init_layer(qubits, gate_set, state_initialization,
                              state_init_kwargs, rng)
            L_br_inv = compute_inverse(L_br, gate_set, inverse, inv_kwargs)
            L_rr_inv = compute_inverse(L_rr, gate_set, inverse, inv_kwargs)

            if mirroring_strategy == 'pauli_rc':
                # M1: forward half unrandomized, reverse half randomized;
                # RC is an operator identity so the reverse-half bitstring is
                # the full-circuit target bitstring
                rev = R_inv + L_br_inv
                rev_rc, bs1 = rc(rev)
                m1 = L_br + T_for_concat + rev_rc
                test_ref_invs.setdefault(m1, []).append(
                    {'base_aux': aux, 'idealout': bs1, 'id': j,
                     'width': len(qubits), 'base_circuit': T.str})

                # M2: everything randomized
                full = L_rr + R + R_inv + L_rr_inv
                m2, bs2 = rc(full)
                ref_ref_invs.setdefault(m2, []).append(
                    {'base_aux': aux, 'idealout': bs2, 'id': j,
                     'width': len(qubits), 'base_circuit': T.str})
            elif mirroring_strategy == 'central_pauli':
                # central-Pauli mirror: L + T + P + conj(T^-1 L^-1)
                rev = R_inv + L_br_inv
                out = _rc.randomize_central_pauli(rev, rng, return_bs=True)
                rev_cp, bs1 = out[0], out[1]
                m1 = L_br + T_for_concat + rev_cp
                test_ref_invs.setdefault(m1, []).append(
                    {'base_aux': aux, 'idealout': bs1, 'id': j,
                     'width': len(qubits), 'base_circuit': T.str})
            else:
                raise ValueError("Unknown mirroring strategy %r"
                                 % mirroring_strategy)

            # M3 / SPAM reference: L + L^-1, randomized
            spam = L_br + L_br_inv
            spam_rc, bs3 = rc(spam)
            spam_refs.setdefault(spam_rc, []).append(
                {'base_aux': aux, 'idealout': bs3, 'id': j,
                 'width': len(qubits), 'base_circuit': T.str})

    edesigns = {}
    if mirroring_strategy == 'pauli_rc':
        edesigns['br'] = FreeformDesign(test_ref_invs)
        edesigns['rr'] = FreeformDesign(ref_ref_invs)
        edesigns['ref'] = FreeformDesign(spam_refs)
    else:
        edesigns['cp'] = FreeformDesign(test_ref_invs)
        edesigns['cpref'] = FreeformDesign(spam_refs)
    return CombinedExperimentDesign(edesigns)
