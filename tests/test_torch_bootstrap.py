"""The port's bootstrap driver against the JAX package's on smq1Q_XYI at
maxL [1, 2]: 'nonparametric' resamples equal count for count, the refits of
two resamples reach the JAX package's within the parity bar (1e-3 relative
in 2DeltaLogL), the error bar of a gauge-dependent quantity after
gauge_optimize_models within 1e-6 relative, and fault (e) of ROADMAP.md
section 3 ('parametric' resamples at each circuit's own total)."""

import numpy as np
import pytest
import torch

import pygsti_tpu.modelpacks.smq1Q_XYI as jmp
from pygsti_tpu.circuits.gstcircuits import create_lsgst_circuit_lists as j_lists
from pygsti_tpu.data import simulate_data as jsim
from pygsti_tpu.drivers import bootstrap as jboot
from pygsti_tpu.objectivefns.objectivefns import ObjectiveFunctionBuilder as JB
from pygsti_tpu.tools.optools import entanglement_infidelity as j_infid

import pygsti_tpu_torch.modelpacks.smq1Q_XYI as tmp
from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.data.dataset import DataSet
from pygsti_tpu_torch.drivers import bootstrap as tboot
from pygsti_tpu_torch.objectivefns.objectivefns import ObjectiveFunctionBuilder as TB
from pygsti_tpu_torch.tools.optools import entanglement_infidelity as t_infid

MAXL = [1, 2]
BAR = 1e-3


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """torch on one thread in this module, beside the other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_dataset(jds):
    tds = DataSet()
    for c in jds.keys():
        tds.add_count_dict(Circuit(c.str), dict(jds[c].counts))
    return tds


def _counts(ds):
    return [(c.str, sorted(ds[c].counts.items())) for c in ds.keys()]


@pytest.fixture(scope='module')
def data():
    jt = jmp.target_model('full TP')
    lists = j_lists(jt, jmp.prep_fiducials(), jmp.meas_fiducials(), jmp.germs(), MAXL)
    jds = jsim(jmp.target_model('full TP').depolarize(op_noise=0.04, spam_noise=0.02),
               list(lists[-1]), 1000, seed=77)
    return dict(jds=jds, tds=_port_dataset(jds), final=list(lists[-1]))


@pytest.fixture(scope='module')
def refits(data):
    """Two resamples refitted from the target by each package."""
    jm, jd = jboot.create_bootstrap_models(
        2, data['jds'], 'nonparametric', jmp.prep_fiducials(), jmp.meas_fiducials(),
        jmp.germs(), MAXL, target_model=jmp.target_model('full TP'), start_seed=5,
        return_data=True)
    stats = []
    tm, td = tboot.create_bootstrap_models(
        2, data['tds'], 'nonparametric', tmp.prep_fiducials(), tmp.meas_fiducials(),
        tmp.germs(), MAXL, target_model=tmp.target_model('full TP'), start_seed=5,
        return_data=True, device='cpu', stats=stats)
    return dict(jm=jm, jd=jd, tm=tm, td=td, stats=stats)


@pytest.mark.parametrize('seed', [0, 5, 2026])
def test_nonparametric_resample_equals_jax(data, seed):
    jds = jboot.create_bootstrap_dataset(data['jds'], 'nonparametric', seed=seed)
    tds = tboot.create_bootstrap_dataset(data['tds'], 'nonparametric', seed=seed)
    assert _counts(tds) == _counts(jds)
    assert _counts(tds) != _counts(data['tds'])


def test_create_bootstrap_models_reach_the_jax_refits(data, refits):
    """Each refit's 2DeltaLogL on its own resample within the parity bar of
    the JAX package's; the resamples themselves equal."""
    for jm, jd, tm, td in zip(refits['jm'], refits['jd'], refits['tm'], refits['td']):
        assert _counts(td) == _counts(jd)
        jv = 2 * JB.create_from('logl').build(jm, jd, data['final']).fn()
        tv = 2 * TB.create_from('logl').build(tm, td, list(td.keys()), device='cpu').fn()
        assert abs(float(tv) - float(jv)) / abs(float(jv)) < BAR
    assert [len(s['optimizer_results']) for s in refits['stats']] == [len(MAXL)] * 2
    assert all(s['seconds'] > 0 for s in refits['stats'])


def test_bootstrap_error_bars_after_gauge_optimization(refits):
    """The mean and standard deviation of Gxpi2:0's entanglement infidelity
    over the gauge-optimized refits agree within 1e-6 relative."""
    jgo = jboot.gauge_optimize_models(refits['jm'], jmp.target_model('full TP'))
    tgo = tboot.gauge_optimize_models(refits['tm'], tmp.target_model('full TP'), device='cpu')
    jt, tt = jmp.target_model('full TP'), tmp.target_model('full TP')
    key = ('Gxpi2', 0)
    jbar = jboot.bootstrap_error_bars(jgo, lambda m: j_infid(
        np.asarray(m.operations[key].to_dense()), np.asarray(jt.operations[key].to_dense())))
    tbar = tboot.bootstrap_error_bars(tgo, lambda m: t_infid(
        m.operations[key].dense(), tt.operations[key].dense()))
    assert tbar[1] > 0
    for j, t in zip(jbar, tbar):
        assert abs(t - j) / abs(j) < 1e-6
    assert np.array_equal(tboot.to_std_array([1.0, 2.0]), jboot.to_std_array([1.0, 2.0]))


def test_fault_e_parametric_draws_each_circuit_at_its_own_total(data):
    """Fault (e): the JAX package's 'parametric' resample draws every
    circuit at the first circuit's total; the port draws each circuit at
    its own, from the model on `device`."""
    jds, tds = data['jds'].copy(), data['tds'].copy()
    for ds, c in ((jds, data['final'][1]), (tds, Circuit(data['final'][1].str))):
        ds.add_count_dict(c, {'0': 500})        # this row now totals 1,500
    jm, tm = jmp.target_model('full TP'), tmp.target_model('full TP')
    jres = jboot.create_bootstrap_dataset(jds, 'parametric', jm, seed=3)
    tres = tboot.create_bootstrap_dataset(tds, 'parametric', tm, seed=3, device='cpu')
    assert {jres[c].total for c in jres.keys()} == {1000.0}
    assert [tres[c].total for c in tres.keys()] == [tds[c].total for c in tds.keys()]
    assert 1500.0 in [tres[c].total for c in tres.keys()]
    with pytest.raises(ValueError):
        tboot.create_bootstrap_dataset(tds, 'parametric', None, device='cpu')
