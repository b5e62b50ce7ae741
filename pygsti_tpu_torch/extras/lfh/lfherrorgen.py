"""Fluctuating-Hamiltonian Lindblad error generator (counterpart of
pygsti_tpu/extras/lfh/lfherrorgen.py; reference:
pygsti/extras/lfh/lfherrorgen.py:40).

The fluctuation averaging lives in lfh.py (batched parameter grids -- see
that module's docstring); this module provides the reference's object
surface: a 1-qubit Lindblad error generator whose Hamiltonian rates are
resampled from Gaussians on demand.  Host numpy.
"""

from __future__ import annotations

import collections

import numpy as np

from pygsti_tpu_torch.baseobjs.basis import Basis
from pygsti_tpu_torch.tools.basistools import change_basis
from pygsti_tpu_torch.tools.lindbladtools import create_elementary_errorgen

# the fixed 1Q non-Hamiltonian coefficient ordering the reference uses
# (lfherrorgen.py:53)
_OTHER_LABELS = [('S', 'X'), ('A', 'X', 'Y'), ('A', 'X', 'Z'),
                 ('C', 'X', 'Z'), ('S', 'Y'), ('A', 'Y', 'Z'),
                 ('C', 'X', 'Y'), ('C', 'Y', 'Z'), ('S', 'Z')]

_PAULIS = {'I': np.eye(2, dtype=complex),
           'X': np.array([[0, 1], [1, 0]], dtype=complex),
           'Y': np.array([[0, -1j], [1j, 0]], dtype=complex),
           'Z': np.diag([1.0, -1.0]).astype(complex)}


class LFHLindbladErrorgen(object):
    """1-qubit Lindblad error generator with Gaussian-fluctuating
    Hamiltonian rates: `h_means` are the mean H(X/Y/Z) rates, `h_devs`
    their standard deviations, and `otherlindbladparams` the 9 S/C/A rates
    in the reference's fixed ordering (reference: lfherrorgen.py:58).
    `sample_hamiltonian_rates()` redraws the H rates."""

    def __init__(self, h_means, otherlindbladparams, h_devs,
                 lindblad_basis='auto', elementary_errorgen_basis='pp',
                 evotype="default", state_space=1,
                 parameterization='CPTPLND', truncate=True, rng=None):
        self.means = np.asarray(h_means, float)
        self.otherlindbladparams = np.asarray(otherlindbladparams, float)
        self.dev_dict = dict(h_devs) if isinstance(h_devs, dict) \
            else {lbl: d for lbl, d in zip('XYZ', h_devs)}
        self.devs = np.fromiter(self.dev_dict.values(), dtype=float)
        if rng is None:
            self.rng = np.random.default_rng()
        elif isinstance(rng, int):
            self.rng = np.random.default_rng(rng)
        else:
            self.rng = rng
        self.paramvals = np.concatenate([self.means,
                                         self.otherlindbladparams])
        self.current_rates = self.paramvals.copy()
        self.matrix_basis = Basis.cast(elementary_errorgen_basis, 4)
        self.coefficients = self.coeff_dict_from_vector()

    @property
    def num_params(self):
        return len(self.paramvals)

    def coeff_dict_from_vector(self):
        """{(type, *pauli_labels): rate} from the current rate vector
        (reference: lfherrorgen.coeff_dict_from_vector:46)."""
        v = self.current_rates
        out = collections.OrderedDict()
        for i, p in enumerate('XYZ'):
            out[('H', p)] = v[i]
        for i, lbl in enumerate(_OTHER_LABELS):
            out[lbl] = v[3 + i]
        return out

    def sample_hamiltonian_rates(self):
        """Redraw the Hamiltonian rates: H_i ~ Normal(mean_i, dev_i)
        (reference: lfherrorgen.sample_hamiltonian_rates)."""
        self.current_rates = self.paramvals.copy()
        self.current_rates[:3] = self.rng.normal(self.means, self.devs)
        self.coefficients = self.coeff_dict_from_vector()
        return self.current_rates[:3]

    def to_vector(self):
        return self.paramvals.copy()

    def from_vector(self, v, close=False, dirty_value=True):
        self.paramvals = np.asarray(v, float).copy()
        self.means = self.paramvals[:3].copy()
        self.otherlindbladparams = self.paramvals[3:].copy()
        self.current_rates = self.paramvals.copy()
        self.coefficients = self.coeff_dict_from_vector()

    def to_dense(self, on_space='minimal'):
        """The error-generator superoperator at the CURRENT (possibly
        resampled) rates, in the elementary-errorgen basis."""
        L = np.zeros((4, 4), complex)
        for lbl, rate in self.coefficients.items():
            typ = lbl[0]
            ps = [_PAULIS[p] for p in lbl[1:]]
            L += rate * create_elementary_errorgen(typ, *ps)
        return np.real(change_basis(L, 'std', self.matrix_basis))
