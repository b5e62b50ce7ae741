"""Process tomography of a black-box channel function (counterpart of
pygsti_tpu/extras/interpygate/process_tomography.py).

Computes the process matrix of a channel given only a function mapping pure
input states to output density matrices (e.g. a physics simulation), by
driving it with an informationally complete set of product states.  No MPI:
the states batch trivially under the single-controller model.  Host work
(numpy).
"""

from __future__ import annotations

import itertools

import numpy as np

from pygsti_tpu_torch.tools.basistools import change_basis


def multi_kron(*a):
    """Kronecker product of all arguments (reference:
    process_tomography.multi_kron)."""
    out = np.array([[1.0]], dtype=complex) if np.ndim(a[0]) > 1 else \
        np.array([1.0], dtype=complex)
    for m in a:
        out = np.kron(out, m)
    return out


def run_process_tomography(state_to_density_matrix_fn, n_qubits=1, comm=None,
                           verbose=False, basis='pp', time_dependent=False,
                           opt_args=None):
    """Process matrix of the channel implemented by
    `state_to_density_matrix_fn` (pure state vector -> density matrix, or a
    list of density matrices when `time_dependent`), in `basis` (reference:
    process_tomography.run_process_tomography:37)."""
    opt_args = opt_args or {}
    def _log(msg):
        if verbose:
            print(msg)
    one_qubit_states = [np.array(s, complex) / np.linalg.norm(s)
                        for s in ([1, 0], [0, 1], [1, 1], [1, 1j])]
    states = [multi_kron(*combo) for combo in
              itertools.product(one_qubit_states, repeat=n_qubits)]
    in_rhos = [np.outer(s, s.conj()) for s in states]
    S = np.column_stack([rho.reshape(-1) for rho in in_rhos])  # [d2, 4^n]
    outs = []
    for k, s in enumerate(states):
        _log("Simulating input state %d / %d" % (k + 1, len(states)))
        r = state_to_density_matrix_fn(s, **opt_args)
        outs.append(r if time_dependent else [r])
    n_times = len(outs[0])
    process_matrices = []
    S_inv = np.linalg.inv(S)
    for t in range(n_times):
        O = np.column_stack([np.asarray(outs[k][t]).reshape(-1)
                             for k in range(len(states))])
        P_std = O @ S_inv
        process_matrices.append(np.real_if_close(
            change_basis(P_std, 'std', basis)))
    return process_matrices if time_dependent else process_matrices[0]
