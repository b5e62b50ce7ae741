"""A short iterative GST fit in the port against the JAX package's, on the
CPU: smq1Q_XYI, 'full TP', maxL <= 4, chi2 stages then a Poisson logL stage,
both from the same target start on the same counts."""

import numpy as np
import pytest

import pygsti_tpu.modelpacks.smq1Q_XYI as jmp
from pygsti_tpu.algorithms.core import run_iterative_gst as j_run
from pygsti_tpu.circuits.gstcircuits import create_lsgst_circuit_lists as j_lists
from pygsti_tpu.data import simulate_data as j_simulate
from pygsti_tpu.objectivefns import two_delta_logl

import pygsti_tpu_torch.modelpacks.smq1Q_XYI as tmp
from pygsti_tpu_torch.algorithms.core import run_iterative_gst as t_run
from pygsti_tpu_torch.circuits.gstcircuits import create_lsgst_circuit_lists as t_lists
from pygsti_tpu_torch.data.dataset import DataSet
from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
from pygsti_tpu_torch.protocols.estimate import misfit_sigma


@pytest.fixture(scope='module')
def fits():
    jt, tt = jmp.target_model('full TP'), tmp.target_model('full TP')
    jl = j_lists(jt, jmp.prep_fiducials(), jmp.meas_fiducials(), jmp.germs(), [1, 2, 4])
    tl = t_lists(tt, tmp.prep_fiducials(), tmp.meas_fiducials(), tmp.germs(), [1, 2, 4])
    jgen = jmp.target_model('full TP').depolarize(op_noise=0.05, spam_noise=0.02)
    jds = j_simulate(jgen, list(jl[-1]), 1000, seed=1234)
    tds = DataSet()   # the same counts in both packages
    for jc, tc in zip(jl[-1], tl[-1]):
        tds.add_count_dict(tc, dict(jds[jc].counts))
    jmodels, jres = j_run(jds, jt, jl, None, ['chi2'], ['logl'])
    tmodels, tres = t_run(tds, tt, tl, None, ['chi2'], ['logl'], device="cpu")
    return jt, jl, tl, jds, tds, jmodels, jres, tmodels, tres


def test_fit_reaches_the_jax_optimum(fits):
    """2*DeltaLogL of both final models, scored by the JAX package's own
    objective: within 1e-3, the bar the JAX package holds against pyGSTi
    (LM stops within its tolerances of the optimum, not on it)."""
    jt, jl, _, jds, _, jmodels, _, tmodels, _ = fits
    port_in_jax = jt.copy()
    port_in_jax.from_vector(tmodels[-1].to_vector())
    circuits = list(jl[-1])
    j_val = two_delta_logl(jmodels[-1], jds, circuits)
    t_val = two_delta_logl(port_in_jax, jds, circuits)
    assert abs(t_val - j_val) < 1e-3, (t_val, j_val)


def test_fit_probabilities_agree(fits):
    """Per-circuit outcome probabilities of the two fits within 1e-4 (the
    fits may differ by a gauge, probabilities may not)."""
    _, jl, tl, _, _, jmodels, _, tmodels, _ = fits
    jp = jmodels[-1].sim.bulk_probs(list(jl[-1]))
    tp = SimpleForwardSimulator(tmodels[-1], device="cpu").bulk_probs(list(tl[-1]))
    diff = max(abs(jp[jc][o] - tp[tc][o]) for jc, tc in zip(jl[-1], tl[-1])
               for o in jp[jc])
    assert diff < 1e-4


def test_stage_values_and_nsigma(fits):
    """Every stage's objective value within 1e-3 relative of the JAX fit's,
    and the port's N_sigma from misfit_sigma equals the JAX package's
    formula on the same numbers."""
    _, jl, _, jds, tds, jmodels, jres, tmodels, tres = fits
    assert [len(r) for r in tres] == [len(r) for r in jres]
    for jr, tr in zip(sum(jres, []), sum(tres, [])):
        assert np.isclose(tr.f, jr.f, rtol=1e-3)
        assert tr.optimizer_specific_qtys['iterations'] >= 1
    k = tds.degrees_of_freedom(list(jl[-1])) - tmodels[-1].num_params
    fit = tres[-1][-1].chi2_k_distributed_qty
    assert np.isclose(misfit_sigma(fit, k), (fit - k) / np.sqrt(2 * k))
    assert abs(misfit_sigma(fit, k)) < 5


def test_run_gst_fit_single_stage(fits):
    """run_gst_fit on one store (the first list, logL) from the target in
    both packages: the same objective value within 1e-6 relative (both LM
    loops stop on the same tolerances from the same start)."""
    from pygsti_tpu.algorithms.core import run_gst_fit as j_fit
    from pygsti_tpu.objectivefns.objectivefns import ModelDatasetCircuitsStore as JStore
    from pygsti_tpu_torch.algorithms.core import run_gst_fit as t_fit
    from pygsti_tpu_torch.objectivefns.objectivefns import \
        ModelDatasetCircuitsStore as TStore
    jt, jl, tl, jds, tds = fits[:5]
    tt = tmp.target_model('full TP')
    jres, _ = j_fit(JStore(jt.copy(), jds, list(jl[0])), None, 'logl')
    tres, tobj = t_fit(TStore(tt, tds, list(tl[0]), device="cpu"), None, 'logl')
    assert np.isclose(tres.f, jres.f, rtol=1e-6)
    assert np.max(np.abs(tobj.model.to_vector() - tres.x)) == 0
