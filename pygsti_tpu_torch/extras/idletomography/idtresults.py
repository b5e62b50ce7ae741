"""Functional idle-tomography results container (counterpart of
pygsti_tpu/extras/idletomography/idtresults.py)."""

from __future__ import annotations


class IdleTomographyResults(object):
    """Intrinsic and observed idle-error rates plus supporting info
    (reference: idtresults.IdleTomographyResults).

    Attributes mirror the reference: `error_list` (NQPauliOp per intrinsic
    rate), `intrinsic_rates` ({'hamiltonian'|'stochastic'|'affine': array}),
    `pauli_fidpairs` ({'samebasis'|'diffbasis': [(prep, meas), ...]}), and
    `observed_rate_infos` ({type: [ {outcome_or_obs: info_dict} per fidpair ]}).
    """

    def __init__(self, dataset, max_lengths, max_error_weight, fit_order,
                 pauli_dicts, idle_str, error_list, intrinsic_rates,
                 pauli_fidpairs, observed_rate_infos):
        self.dataset = dataset
        self.max_lengths = max_lengths
        self.max_error_weight = max_error_weight
        self.fit_order = fit_order
        self.prep_basis_strs, self.meas_basis_strs = pauli_dicts
        self.idle_str = idle_str
        self.error_list = list(error_list)
        self.intrinsic_rates = dict(intrinsic_rates)
        self.pauli_fidpairs = dict(pauli_fidpairs)
        self.observed_rate_infos = dict(observed_rate_infos)
        self.predicted_obs_rates = None  # may hold true/predicted rates

    def __str__(self):
        s = "Idle Tomography Results\n"
        for typ in ('stochastic', 'affine', 'hamiltonian'):
            if typ in self.intrinsic_rates:
                s += "Intrinsic %s rates:\n" % typ
                s += "\n".join("  %s: %g" % (str(err), rate) for err, rate in
                               zip(self.error_list, self.intrinsic_rates[typ]))
                s += "\n"
        return s
