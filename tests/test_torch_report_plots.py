"""The port's report plots and the drift, idle-tomography, FOGI and VB
reports against the JAX package's, on the CPU: the colormaps on a grid of
values, the per-circuit 2*DeltaLogL and chi2 behind the box plot (1e-10
relative to the largest), the box plot, scatter and histogram, the
Workspace's outputs, and each other report's page on the same inputs
(every number within one unit of its last printed digit; the inputs are
those of tests/test_torch_drift.py, test_torch_idletomography.py,
test_torch_fogi.py and test_torch_mirror.py).
"""

import types

import numpy as np
import pytest
import torch

from pygsti_tpu.report import colormaps as jcm
from pygsti_tpu.report import workspaceplots as jwp
from pygsti_tpu.report.workspace import Workspace as JWorkspace

from pygsti_tpu_torch.report import colormaps as tcm
from pygsti_tpu_torch.report import workspaceplots as twp
from pygsti_tpu_torch.report.workspace import Workspace as TWorkspace

from test_torch_report import pair, same_page  # noqa: F401  (the module's fixture)


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """torch on one thread in this module, beside the other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- colormaps -------------------------------------------------------------------

def _grid(vmax):
    return np.concatenate([np.linspace(0, vmax, 23), [0.0, 1e-8, vmax * 0.999, -1.0,
                                                      vmax * 2]])


COLORMAPS = {
    'linlog': lambda m: m.LinlogColormap(0, 40.0, 100, 0.05, 1),
    'linlog-3dof': lambda m: m.LinlogColormap(0, 200.0, 2000, 0.05, 3),
    'linlog-manual': lambda m: m.LinlogColormap.set_manual_transition_point(0, 10.0, 4.0,
                                                                             'blue'),
    'diverging': lambda m: m.DivergingColormap(-3, 3),
    'sequential': lambda m: m.SequentialColormap(0, 5.0, 'whiteToRed'),
    'piecewise': lambda m: m.PiecewiseLinearColormap([(0.0, (1., 1., 1.)), (2.0, (0., 1., 0.)),
                                                      (5.0, (0., 0., 1.))]),
}


@pytest.mark.parametrize("name", sorted(COLORMAPS))
def test_colormaps_match_jax(name):
    t, j = COLORMAPS[name](tcm), COLORMAPS[name](jcm)
    vmax = 40.0 if name.startswith('linlog') else 5.0
    for v in _grid(vmax):
        assert np.array_equal(np.asarray(t.normalize(v)), np.asarray(j.normalize(v)),
                              equal_nan=True), v
        assert t.interpolate_color(v) == j.interpolate_color(v), v
        assert t.interpolate_hex(v) == j.interpolate_hex(v), v
        assert t.besttxtcolor(v) == j.besttxtcolor(v), v
    assert t.create_plotly_colorscale() == j.create_plotly_colorscale()
    assert np.array_equal(tcm.to_rgb_array('rgb(1,2,3)'), jcm.to_rgb_array('rgb(1,2,3)'))
    assert np.array_equal(tcm.to_rgb_array('#00FF88'), jcm.to_rgb_array('#00FF88'))


# -- per-circuit values, the box plot and its summaries -----------------------------

@pytest.fixture(scope='module')
def percircuit(pair):  # noqa: F811
    jm = pair['jmodels']['final iteration estimate']
    tm = pair['tmodels']['final iteration estimate']
    jstruct = pair['jres'].data.edesign.circuit_lists[-1]
    tstruct = pair['tres'].data.edesign.circuit_lists[-1]
    out = {}
    for objective in ('logl', 'chi2'):
        t = twp.per_circuit_2dlogl(tm, pair['tds'], list(tstruct), objective, device='cpu')
        j = jwp.per_circuit_2dlogl(jm, pair['jds'], list(jstruct), objective)
        out[objective] = (t, j)
    return out, jm, tm, jstruct, tstruct


@pytest.mark.parametrize("objective", ['logl', 'chi2'])
def test_per_circuit_values_match_jax(percircuit, objective):
    (vals, *_), (t, j) = percircuit, percircuit[0][objective]
    assert [c.str for c in t] == [c.str for c in j]
    tv, jv = np.array(list(t.values())), np.array(list(j.values()))
    assert np.max(np.abs(tv - jv)) <= 1e-10 * np.max(np.abs(jv))


@pytest.mark.parametrize("plot", ['box', 'scatter', 'histogram', 'section'])
def test_box_plot_and_summaries_match_jax(percircuit, pair, plot):  # noqa: F811
    vals, jm, tm, jstruct, tstruct = percircuit
    t, j = vals['logl']
    if plot == 'box':
        a = twp.color_boxplot_html(tstruct, t, title='x', model=tm)
        b = jwp.color_boxplot_html(jstruct, j, title='x', model=jm)
        assert a.count('class="bx"') == sum(len(p) for p in tstruct.plaquettes.values())
    elif plot == 'scatter':
        a, b = twp.scatter_plot_html(t, model=tm), jwp.scatter_plot_html(j, model=jm)
    elif plot == 'histogram':
        a, b = twp.histogram_plot_html(t, model=tm), jwp.histogram_plot_html(j, model=jm)
    else:
        a = twp.model_violation_boxplot_html(tm, pair['tds'], tstruct, device='cpu')
        b = jwp.model_violation_boxplot_html(jm, pair['jds'], jstruct)
    assert same_page(a, b)


def test_colormap_of_a_model_without_povms_raises():
    """The JAX package's box plot colormap assumes two outcomes when it
    cannot read the model's POVMs; the port's raises."""
    vals = {'c%d' % i: float(i) for i in range(10)}
    assert jwp._linlog_colormap(vals, types.SimpleNamespace()).dof == 1
    with pytest.raises(AttributeError):
        twp._linlog_colormap(vals, types.SimpleNamespace())


@pytest.mark.parametrize("method", ['GatesVsTargetTable', 'SpamVsTargetTable', 'GatesTable',
                                    'GatesTable-boxes', 'ChoiTable', 'GateEigenvalueTable',
                                    'ColorBoxPlot', 'ColorBoxPlot-scatter',
                                    'ColorBoxPlot-histogram', 'FitComparisonTable'])
def test_workspace_outputs_match_jax(pair, method):  # noqa: F811
    jm, tm = pair['jmodels'], pair['tmodels']
    tws, jws = TWorkspace(device='cpu'), JWorkspace()
    name, _, variant = method.partition('-')
    if name in ('GatesVsTargetTable', 'SpamVsTargetTable'):
        args = lambda m: (m['stdgaugeopt'], m['target'])  # noqa: E731
        kwargs = {}
    elif name == 'GateEigenvalueTable':
        args, kwargs = (lambda m: (m['stdgaugeopt'], m['target'])), {}
    elif name in ('GatesTable', 'ChoiTable'):
        args = lambda m: (m['stdgaugeopt'],)  # noqa: E731
        kwargs = {'display_as': variant} if variant else {}
    elif name == 'ColorBoxPlot':
        def args(m):
            res = pair['tres'] if m is tm else pair['jres']
            return ('logl', res.data.edesign.circuit_lists[-1], res.data.dataset,
                    m['final iteration estimate'])
        kwargs = {'typ': variant} if variant else {}
    else:
        def args(m):
            res = pair['tres'] if m is tm else pair['jres']
            lists = res.data.edesign.circuit_lists
            return ([1, 2], lists[1:], [m['final iteration estimate']] * 2, res.data.dataset)
        kwargs = {}
    a = getattr(tws, name)(*args(tm), **kwargs).render()
    b = getattr(jws, name)(*args(jm), **kwargs).render()
    assert same_page(a, b)


def test_switchboard_and_small_outputs():
    ws = TWorkspace(device='cpu')
    sb = ws.Switchboard(['Estimate'], [['a', 'b']])
    sb.add('a', '<p>A</p>')
    sb.add('b', '<p>B</p>')
    html = sb.render()
    assert html.count('<option') == 2 and '<p>A</p>' in html and '<p>B</p>' in html
    from pygsti_tpu_torch.report import workspace as tw
    sv = tw.SwitchValue(sb, 'v', [0])
    sv[1] = 'x'
    assert sv[1] == 'x' and sv.base.shape == (2,)
    assert tw.SwitchboardView(sb).switch_names == ['Estimate']
    assert 'N/A' in tw.NotApplicable(ws).render()
    assert len(tw.random_id()) == 8 and not tw.in_ipython_notebook()
    assert tw.enable_plotly_pickling() is None and tw.disable_plotly_pickling() is None


# -- the drift, idle-tomography, FOGI and VB reports -------------------------------

def test_drift_report_matches_jax(tmp_path):
    """create_drift_report of StabilityAnalysis results on the drifting
    clickstreams of tests/test_torch_drift.py."""
    from test_torch_drift import (JData, JDesign, JStability, TData, TDesign, TStability,
                                  make_drifting_datasets)
    from pygsti_tpu.report.factory import create_drift_report as jdrift
    from pygsti_tpu_torch.report.factory import create_drift_report as tdrift
    jd, td = make_drifting_datasets(n_circuits=3, T=400)
    jres = JStability().run(JData(JDesign(list(jd.keys())), jd))
    tres = TStability(device='cpu').run(TData(TDesign(list(td.keys())), td))
    assert tres.instability_detected and len(tres.unstable_circuits) == 1
    a = open(tdrift(tres).write_html(str(tmp_path / 't.html'))).read()
    b = open(jdrift(jres).write_html(str(tmp_path / 'j.html'))).read()
    assert same_page(a, b) and '1 drifting' in a


def test_idle_tomography_report_matches_jax(tmp_path):
    """create_idletomography_report of the 2-qubit protocol results of
    tests/test_torch_idletomography.py, from extras.idletomography."""
    from test_torch_idletomography import JData, _idle_model, _jax_ds, jidt, tidt
    from pygsti_tpu_torch.data.datasetconstruction import simulate_data
    from pygsti_tpu_torch.protocols.protocol import ProtocolData
    td = tidt.IdleTomographyDesign((0, 1), max_lengths=(0, 1, 2, 4), maxweight=2)
    jd = jidt.IdleTomographyDesign((0, 1), max_lengths=(0, 1, 2, 4), maxweight=2)
    ds = simulate_data(_idle_model(2, ham_z=0.01, sto_z=0.006, sto_zz=0.005),
                       td.all_circuits_needing_data, 50000, seed=3, device='cpu')
    tres = tidt.IdleTomography().run(ProtocolData(td, ds))
    jres = jidt.IdleTomography().run(JData(jd, _jax_ds(ds)))
    a = open(tidt.create_idletomography_report(tres, str(tmp_path / 't.html')).write_html(
        str(tmp_path / 't.html'))).read()
    b = open(jidt.create_idletomography_report(jres, str(tmp_path / 'j.html')).write_html(
        str(tmp_path / 'j.html'))).read()
    assert same_page(a, b) and 'Correlated' in a


def test_fogi_diagram_matches_jax():
    """FOGIDiagram of the 1-qubit 'H+s' model of tests/test_torch_fogi.py
    at random FOGI components: the rates table (1e-12) and the page."""
    from test_torch_fogi import JLabel, Label, _abbrevs, jmp1, tmp1
    from pygsti_tpu.report.fogidiagram import FOGIDiagram as JFOGI
    from pygsti_tpu_torch.report.fogidiagram import FOGIDiagram as TFOGI
    jm, tm = jmp1.target_model('H+s'), tmp1.target_model('H+s')
    jm.setup_fogi(op_label_abbrevs=_abbrevs(JLabel), include_spam=True)
    tm.setup_fogi(op_label_abbrevs=_abbrevs(Label), include_spam=True)
    ar = 1e-3 * (np.random.RandomState(7).rand(18) - 0.5)
    jm.set_fogi_errorgen_components_array(ar)
    tm.set_fogi_errorgen_components_array(ar)
    t, j = TFOGI(tm), JFOGI(jm)
    rt, rj = t.rates_table(), j.rates_table()
    assert [(n, k) for n, _, k in rt] == [(n, k) for n, _, k in rj]
    assert max(abs(a[1] - b[1]) for a, b in zip(rt, rj)) < 1e-12
    assert [str(k) for k in t.aggregate_by_op()] == [str(k) for k in j.aggregate_by_op()]
    assert same_page(t.render_html(), j.render_html())


@pytest.mark.parametrize("seed", [0, 1])
def test_vb_plots_match_jax(seed):
    """volumetric_plot_html, capability_region_plot_html and
    volumetric_boundary_data of the VBDataFrame of tests/test_torch_mirror.py's
    rows."""
    import pandas as pd
    from test_torch_mirror import _vb_rows, jvbdf, tvbdf
    from pygsti_tpu.report import vbplot as jvb
    from pygsti_tpu_torch.report import vbplot as tvb
    rows = _vb_rows(seed)
    a, b = tvbdf.VBDataFrame.from_benchmarking_data(rows), jvbdf.VBDataFrame(pd.DataFrame(rows))
    assert same_page(tvb.capability_region_plot_html(a), jvb.capability_region_plot_html(b))
    data_t, data_j = a.vb_data(), b.vb_data()
    assert same_page(tvb.volumetric_plot_html(data_t, title='VB'),
                     jvb.volumetric_plot_html(data_j, title='VB'))
    assert tvb.volumetric_boundary_data(data_t) == jvb.volumetric_boundary_data(data_j)
