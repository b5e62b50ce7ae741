"""Idle tomography: Pauli-basis characterization of idle errors
(counterpart of pygsti_tpu/extras/idletomography/), with the idle
tomography report of report/idtreport.py."""

from pygsti_tpu_torch.extras.idletomography.idtcore import (
    IdleTomographyDesign, IdleTomography, IdleTomographyProtocolResults,
    run_idle_tomography_protocol,
    hamiltonian_jac_element, stochastic_outcome, stochastic_jac_element,
    affine_jac_element, affine_jac_obs_element, idle_tomography_fidpairs,
    preferred_signs_from_paulidict, fidpairs_to_pauli_fidpairs,
    determine_paulidicts, make_idle_tomography_list,
    make_idle_tomography_lists, compute_observed_samebasis_err_rate,
    compute_observed_diffbasis_err_rate, do_idle_tomography)
from pygsti_tpu_torch.extras.idletomography.idtresults import IdleTomographyResults
from pygsti_tpu_torch.extras.idletomography.pauliobjs import (NQOutcome, NQPauliState,
                                                              NQPauliOp)
from pygsti_tpu_torch.extras.idletomography import idttools
from pygsti_tpu_torch.report.idtreport import create_idletomography_report
