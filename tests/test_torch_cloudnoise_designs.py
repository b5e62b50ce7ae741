"""Cloud-noise designs, objectives and fits in the port against the JAX
package: create_cloudnoise_circuits (the same circuit strings for the same
arguments and seed), the k-coverage templates, the blocked objective of the
162-parameter 2-qubit cloud model, and a small 2-qubit cloud-noise fit in
both packages on the same counts."""

import numpy as np
import pytest
import torch

from pygsti_tpu.circuits import Circuit as JCircuit
from pygsti_tpu.circuits import cloudcircuitconstruction as jccc
from pygsti_tpu.data import simulate_data as j_simulate
from pygsti_tpu.models import cloudnoisemodel as jcnm
from pygsti_tpu.objectivefns import objectivefns as jof
from pygsti_tpu.processors import QubitProcessorSpec as JSpec

from pygsti_tpu_torch.circuits import cloudcircuitconstruction as tccc
from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.data.dataset import DataSet
from pygsti_tpu_torch.models import cloudnoisemodel as tcnm
from pygsti_tpu_torch.objectivefns import objectivefns as tof
from pygsti_tpu_torch.processors.processorspec import QubitProcessorSpec as TSpec

GATES = ['Gxpi2', 'Gypi2', 'Gcnot']
FIDS = [(), ('Gxpi2',), ('Gypi2',), ('Gxpi2', 'Gxpi2')]


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """torch on one thread in this module, beside the other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same_counts(jds, strs):
    tds = DataSet()
    for s in strs:
        tds.add_count_dict(Circuit(s), dict(jds[JCircuit(s)].counts))
    return tds


@pytest.fixture(scope='module')
def fit_setup():
    """The 2-qubit cloud model of 162 parameters (maxhops 1, extra gate
    weight 1), the design of tests/test_cloudnoise.py:196 at maxL 4, and the
    JAX package's counts from a truth with an idle H_X of 0.03."""
    jspec, tspec = JSpec(2, GATES, geometry='line'), TSpec(2, GATES, geometry='line')
    kw = dict(max_idle_weight=1, maxhops=0, extra_gate_weight=0, max_candidates=48, seed=3)
    jstruct = jccc.create_cloudnoise_circuits(jspec, [1, 2, 4], FIDS, **kw)
    tstruct = tccc.create_cloudnoise_circuits(tspec, [1, 2, 4], FIDS, device='cpu', **kw)
    strs = [c.str for c in jstruct]
    jtruth = jcnm.create_cloud_crosstalk_model_from_hops_and_weights(
        jspec, maxhops=0, max_idle_weight=1, gate_type='H+s')
    vt = np.zeros(jtruth.num_params)
    lbls = jtruth.idle_member.errorgen.blocks[0].basis_element_labels
    vt[jtruth.idle_member.gpindices.start + lbls.index('XI')] = 0.03
    jtruth.from_vector(vt)
    jds = j_simulate(jtruth, list(jstruct), 20000, seed=11)
    return dict(jstruct=jstruct, tstruct=tstruct, strs=strs, jds=jds,
                tds=_same_counts(jds, strs), vt=vt, jspec=jspec, tspec=tspec)


def test_cloudnoise_circuits_equal(fit_setup):
    """create_cloudnoise_circuits: the same circuit strings, germs and
    lengths as the JAX package for the same arguments and seed."""
    js, ts = fit_setup['jstruct'], fit_setup['tstruct']
    assert [c.str for c in ts] == fit_setup['strs']
    assert ts.xs == js.xs == [1, 2, 4]
    assert [g.str for g in ts.ys] == [g.str for g in js.ys]
    assert ts.ys[0].str == '[]@(0,1)'
    plaq = ts.plaquette(4, ts.ys[0])
    assert plaq.power == 4 and plaq.base.depth == 4


@pytest.mark.parametrize("maxhops,extra", [(1, 1), (1, 0)])
def test_cloudnoise_circuits_with_clouds(maxhops, extra):
    """Clouds that span both qubits (maxhops 1), at maxL 2: the same
    circuits as the JAX package."""
    kw = dict(max_idle_weight=1, maxhops=maxhops, extra_gate_weight=extra, max_candidates=12,
              seed=5)
    js = jccc.create_cloudnoise_circuits(JSpec(2, GATES, geometry='line'), [1, 2], FIDS, **kw)
    ts = tccc.create_cloudnoise_circuits(TSpec(2, GATES, geometry='line'), [1, 2], FIDS,
                                         device='cpu', **kw)
    assert [c.str for c in ts] == [c.str for c in js]


@pytest.mark.parametrize("n,k", [(3, 1), (4, 2), (6, 2), (5, 3), (6, 3), (4, 4)])
def test_kcoverage_templates(n, k):
    """The same k-coverage rows as the JAX package, each checked."""
    rows = tccc.create_kcoverage_template(n, k)
    assert rows == jccc.create_kcoverage_template(n, k)
    tccc.check_kcoverage_template(rows, n, k)
    with pytest.raises(AssertionError):
        tccc.check_kcoverage_template([[0, 1, 0], [0, 0, 1], [1, 1, 0]], 3, 2)


def _objective_pair(fit_setup, name, jm, tm):
    jraw = jof.ObjectiveFunctionBuilder(name).build_raw()
    strs = fit_setup['strs']
    jobj = jof.TimeIndependentMDCObjectiveFunction(jraw, jm, fit_setup['jds'],
                                                   [JCircuit(s) for s in strs])
    tobj = tof.ObjectiveFunctionBuilder(name).build(tm, fit_setup['tds'],
                                                    [Circuit(s) for s in strs], device='cpu')
    return jobj, tobj


@pytest.mark.parametrize("name", ['chi2', 'logl'])
def test_blocked_objective(fit_setup, name):
    """The 162-parameter cloud model's blocked lsvec, J^T J and J^T f
    against the JAX package's at a seeded point off the ties: 1e-9
    relative, on the same op stack (three of its layers parallel)."""
    jspec, tspec = fit_setup['jspec'], fit_setup['tspec']
    jm = jcnm.create_cloud_crosstalk_model_from_hops_and_weights(
        jspec, maxhops=1, max_idle_weight=1, extra_gate_weight=1, gate_type='H+s')
    tm = tcnm.create_cloud_crosstalk_model_from_hops_and_weights(
        tspec, maxhops=1, max_idle_weight=1, extra_gate_weight=1, gate_type='H+s')
    assert tm.num_params == 162
    theta = 0.01 * np.random.RandomState(21).randn(162)
    jm.from_vector(theta)
    tm.from_vector(theta)
    jobj, tobj = _objective_pair(fit_setup, name, jm, tm)
    assert tobj.jac_mode == 'blocked'
    assert [str(k) for k in tm.op_keys] == [str(k) for k in jm.op_keys]
    assert sum(len(k.components) > 1 for k in tm.op_keys) == 3
    f = tobj.counts / tobj.total_counts
    assert np.min(np.abs(tobj.probs(theta) - f)) > 1e-6
    assert abs(tobj.fn(theta) - jobj.fn(theta)) <= 1e-9 * abs(jobj.fn(theta))
    for a, b in zip(tobj.jtj_jtf(theta), jobj.jtj_jtf(theta)):
        assert a.shape == b.shape
        assert np.max(np.abs(a - b)) <= 1e-9 * np.max(np.abs(b))


def test_fit_at_the_jax_packages_optimum(fit_setup):
    """tests/test_cloudnoise.py:196's fit (chi2 from zero, maxiter 60) in
    both packages on the same counts: the final 2DeltaLogL within 1e-3
    relative (the parity bar), the planted idle H_X within 0.01, and no
    worse than the truth's + 10."""
    from pygsti_tpu.algorithms.core import run_gst_fit_simple as j_fit
    from pygsti_tpu.tools.likelihoodfns import two_delta_logl as j_tdl
    from pygsti_tpu_torch.algorithms.core import run_gst_fit_simple as t_fit
    jspec, tspec = fit_setup['jspec'], fit_setup['tspec']
    strs = fit_setup['strs']
    jstart = jcnm.create_cloud_crosstalk_model_from_hops_and_weights(
        jspec, maxhops=0, max_idle_weight=1, gate_type='H+s')
    tstart = tcnm.create_cloud_crosstalk_model_from_hops_and_weights(
        tspec, maxhops=0, max_idle_weight=1, gate_type='H+s')
    _, jobj = j_fit(fit_setup['jds'], jstart, [JCircuit(s) for s in strs],
                    optimizer={'maxiter': 60},
                    objective_function_builder=jof.ObjectiveFunctionBuilder.cast('chi2'))
    _, tobj = t_fit(fit_setup['tds'], tstart, [Circuit(s) for s in strs],
                    optimizer={'maxiter': 60}, objective_function_builder='chi2', device='cpu')
    jv, tv = np.asarray(jobj.model.to_vector()), tobj.model.to_vector()
    tdl_j = j_tdl(jobj.model, fit_setup['jds'], [JCircuit(s) for s in strs])
    tdl_t = tof.two_delta_logl(tobj.model, fit_setup['tds'], [Circuit(s) for s in strs],
                               device='cpu')
    truth = tstart.copy()
    truth.from_vector(fit_setup['vt'])
    tdl_truth = tof.two_delta_logl(truth, fit_setup['tds'], [Circuit(s) for s in strs],
                                   device='cpu')
    lbls = tstart.idle_member.errorgen.blocks[0].basis_element_labels
    planted = tstart.idle_member.gpindices.start + lbls.index('XI')
    assert abs(tdl_t - tdl_j) <= 1e-3 * abs(tdl_j)
    assert abs(tv[planted] - 0.03) < 0.01 and abs(jv[planted] - 0.03) < 0.01
    assert tdl_t < tdl_truth + 10.0


def test_greedy_rank_select_keeps_its_basis_orthonormal():
    """The rank selection of create_cloudnoise_circuits projects each
    residual off the spanned basis twice and orthonormalizes the rows it
    adds.  Candidates that lie in the span of a basis whose rows have
    drifted 1e-6 from orthonormal (the JAX package's single projection
    drifts without bound over the 3-qubit design: its basis reached 717
    rows for 534 parameters) add no rank in the port and spurious rank in
    the JAX package; on fresh candidates both choose the same, and the
    port's basis stays orthonormal to 1e-13."""
    rng = np.random.RandomState(8)
    P, r = 40, 24
    Q0 = np.linalg.qr(rng.randn(P, r))[0].T
    drifted = Q0 + 1e-6 * rng.randn(r, P)
    inside = [rng.randn(6, r) @ drifted for _ in range(10)]
    assert tccc._greedy_rank_select(inside, drifted)[0] == []
    assert len(jccc._greedy_rank_select(inside, drifted)[0]) > 0
    fresh = [rng.randn(6, 5) @ rng.randn(5, P) for _ in range(12)]
    chosen_t, Qt = tccc._greedy_rank_select(fresh, None)
    chosen_j, Qj = jccc._greedy_rank_select(fresh, None)
    assert chosen_t == chosen_j and Qt.shape == Qj.shape == (P, P)
    assert np.max(np.abs(Qt @ Qt.T - np.eye(P))) < 1e-13
