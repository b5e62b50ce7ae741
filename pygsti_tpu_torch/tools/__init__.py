"""Numerical tools: basis changes, superoperator conversions, metrics,
likelihoods and the small host utilities (counterpart of
pygsti_tpu/tools)."""

from pygsti_tpu_torch.tools import basistools
from pygsti_tpu_torch.tools import matrixtools
from pygsti_tpu_torch.tools import optools
from pygsti_tpu_torch.tools import internalgates
from pygsti_tpu_torch.tools import lindbladtools
from pygsti_tpu_torch.tools import jamiolkowski

from pygsti_tpu_torch.tools import likelihoodfns
from pygsti_tpu_torch.tools import chi2fns

from pygsti_tpu_torch.tools.basistools import change_basis, stdmx_to_vec, vec_to_stdmx
from pygsti_tpu_torch.tools.optools import (
    unitary_to_superop, unitary_to_pauligate, unitary_to_std_process_mx,
    fidelity, entanglement_fidelity, average_gate_fidelity, frobeniusdist,
    jtracedist, process_fidelity, state_to_dmvec, dmvec_to_state,
    diamonddist, tracedist, tracenorm, unitarity, decompose_gate_matrix,
    kraus_decomposition, error_generator, operation_from_error_generator,
    superop_to_unitary, entanglement_infidelity, average_gate_infidelity,
    eigenvalue_entanglement_infidelity, is_cptp,
)
from pygsti_tpu_torch.tools.likelihoodfns import (
    logl, logl_max, two_delta_logl, logl_jacobian, logl_hessian,
    logl_approximate_hessian,
)
from pygsti_tpu_torch.tools.chi2fns import (
    chi2, chi2_per_circuit, chi2_jacobian, chi2fn, chi2fn_wfreqs,
    chi2fn_2outcome, chi2fn_2outcome_wfreqs,
)
from pygsti_tpu_torch.tools import exceptions
from pygsti_tpu_torch.tools import legacytools
from pygsti_tpu_torch.tools import pdftools
from pygsti_tpu_torch.tools import locking
from pygsti_tpu_torch.tools.pdftools import tvd, classical_fidelity
from pygsti_tpu_torch.tools import rbtools
from pygsti_tpu_torch.tools import rbtheory
from pygsti_tpu_torch.tools.rbtools import p_to_r, r_to_p
from pygsti_tpu_torch.tools.rbtheory import (predicted_rb_number,
                                             predicted_rb_decay_parameter)
from pygsti_tpu_torch.tools import slicetools
from pygsti_tpu_torch.tools import listtools
from pygsti_tpu_torch.tools.typeddict import TypedDict
from pygsti_tpu_torch.tools import hypothesis
from pygsti_tpu_torch.tools import group
from pygsti_tpu_torch.tools.gatetools import single_qubit_gate, two_qubit_gate
from pygsti_tpu_torch.tools import dataframetools
from pygsti_tpu_torch.tools import errgenpolytools
from pygsti_tpu_torch.tools import mptools
