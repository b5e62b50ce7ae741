"""Workspace: factory of renderable report tables and plots (counterpart
of pygsti_tpu/report/workspace.py).

Each factory method returns a Workspace output object whose ``render()``
gives a self-contained HTML fragment, composable into reports or shown in
notebooks through ``_repr_html_``.  Without plotly, which neither package
requires, the plotly pickling hooks do nothing.
"""

from __future__ import annotations

import html as _html

import numpy as np

from pygsti_tpu_torch.baseobjs.smartcache import SmartCache


class WorkspaceOutput(object):
    """Base for renderable workspace objects."""

    def __init__(self, ws, html):
        self.ws = ws
        self._html = html

    def render(self, typ='html'):
        assert typ == 'html', "only HTML rendering is supported"
        return self._html

    def _repr_html_(self):
        return self._html


class WorkspaceTable(WorkspaceOutput):
    pass


class WorkspacePlot(WorkspaceOutput):
    pass


def _table_html(headers, rows):
    h = ''.join('<th>%s</th>' % _html.escape(str(x)) for x in headers)
    body = ''.join('<tr>%s</tr>' % ''.join(
        '<td>%s</td>' % (x if isinstance(x, str) and x.startswith('<')
                         else _html.escape(str(x))) for x in r)
        for r in rows)
    return ('<table border="1" cellspacing="0" cellpadding="3">'
            '<tr>%s</tr>%s</table>' % (h, body))


class Switchboard(object):
    """Interactive selector switching between variants of report content
    (reference: workspace.py:725 Switchboard): renders an HTML <select> per
    switch; content blocks registered per switch-position combination are
    shown/hidden client-side.

    Usage::

        sb = Switchboard(ws, ['Estimate'], [['full TP', 'CPTPLND']])
        sb.add('full TP', some_table.render())
        sb.add('CPTPLND', other_table.render())
        html = sb.render()
    """

    _counter = [0]

    def __init__(self, ws, switch_names, switch_positions):
        self.ws = ws
        self.switch_names = list(switch_names)
        self.switch_positions = [list(p) for p in switch_positions]
        self._blocks = {}    # position-key (tuple or scalar) -> [html, ...]
        Switchboard._counter[0] += 1
        self._sid = 'swb%d' % Switchboard._counter[0]

    def add(self, position, html):
        """Register an HTML block shown when the switches are at `position`
        (a scalar for one switch, else a tuple)."""
        key = position if isinstance(position, tuple) else (position,)
        self._blocks.setdefault(key, []).append(html)

    def render(self, typ='html'):
        assert typ == 'html'
        sid = self._sid
        selects = []
        for i, (name, positions) in enumerate(
                zip(self.switch_names, self.switch_positions)):
            opts = ''.join('<option value="%s">%s</option>'
                           % (_html.escape(str(p)), _html.escape(str(p)))
                           for p in positions)
            selects.append(
                '<label style="margin-right:1em">%s: '
                '<select id="%s_s%d" onchange="%s_update()">%s</select>'
                '</label>' % (_html.escape(name), sid, i, sid, opts))
        blocks = []
        for key, htmls in self._blocks.items():
            key_attr = _html.escape('|'.join(str(k) for k in key))
            blocks.append('<div class="%s_blk" data-key="%s" '
                          'style="display:none">%s</div>'
                          % (sid, key_attr, ''.join(htmls)))
        script = (
            '<script>function %(s)s_update(){'
            'var key=[];var i=0;'
            'while(true){var el=document.getElementById("%(s)s_s"+i);'
            'if(!el)break;key.push(el.value);i++;}'
            'var want=key.join("|");'
            'var blks=document.getElementsByClassName("%(s)s_blk");'
            'for(var j=0;j<blks.length;j++){'
            'blks[j].style.display='
            '(blks[j].getAttribute("data-key")==want)?"block":"none";}}'
            'document.addEventListener("DOMContentLoaded",%(s)s_update);'
            '%(s)s_update();</script>' % {'s': sid})
        return ('<div class="switchboard">%s%s%s</div>'
                % (''.join(selects), ''.join(blocks), script))

    def _repr_html_(self):
        return self.render()


class Workspace(object):
    """Factory of report tables and plots; its plots simulate on `device`."""

    def __init__(self, cachefile=None, device="cuda"):
        self.smartCache = SmartCache()
        self.device = device

    def Switchboard(self, switch_names, switch_positions):
        """Create an interactive Switchboard (reference: workspace.py:725)."""
        return Switchboard(self, switch_names, switch_positions)

    # -- tables ---------------------------------------------------------------

    def GatesVsTargetTable(self, model, target_model, confidence_region_info=None):
        from pygsti_tpu_torch.report import reportables as _rpt
        crf = confidence_region_info
        gm = _rpt.gate_metrics_table(model, target_model, crf_view=crf)
        if not gm:
            return WorkspaceTable(self, '<p>(no gates)</p>')
        metrics = list(next(iter(gm.values())).keys())
        rows = [[str(lbl)] + [row[m] for m in metrics]
                for lbl, row in gm.items()]
        return WorkspaceTable(self, _table_html(['Gate'] + metrics, rows))

    def SpamVsTargetTable(self, model, target_model, confidence_region_info=None):
        from pygsti_tpu_torch.report import reportables as _rpt
        sm = _rpt.spam_metrics_table(model, target_model,
                                     crf_view=confidence_region_info)
        rows = [['%s %s' % (kind, lbl)]
                + [('%.6g' % v) if isinstance(v, float) else str(v)
                   for v in d.values()]
                for (kind, lbl), d in sm.items()]
        headers = ['Item'] + (list(next(iter(sm.values())).keys()) if sm else [])
        return WorkspaceTable(self, _table_html(headers, rows))

    def GatesTable(self, model, display_as='numbers'):
        """Gate matrices as numeric cells ('numbers') or color-mapped boxes
        ('boxes', diverging colormap -- reference workspacetables
        GatesTable display_as)."""
        if display_as not in ('numbers', 'boxes'):
            raise ValueError("display_as must be 'numbers' or 'boxes'")
        if display_as == 'boxes':
            from pygsti_tpu_torch.report.colormaps import DivergingColormap
        rows = []
        for lbl, op in model.operations.items():
            m = np.asarray(op.dense())
            if display_as == 'boxes':
                amax = max(float(np.max(np.abs(m))), 1e-12)
                cmap = DivergingColormap(-amax, amax)
                cells = []
                for r in m:
                    tds = ''.join(
                        '<td style="background-color:%s" title="%.4g">'
                        '&nbsp;</td>' % (cmap.interpolate_color(x), x)
                        for x in r)
                    cells.append('<tr>%s</tr>' % tds)
                mat = '<table class="boxtable">' + ''.join(cells) + '</table>'
            else:
                mat = '<table>' + ''.join(
                    '<tr>%s</tr>' % ''.join('<td>%.4f</td>' % x for x in r)
                    for r in m) + '</table>'
            rows.append([str(lbl), mat])
        return WorkspaceTable(self, _table_html(['Gate', 'Matrix'], rows))

    def ChoiTable(self, model):
        from pygsti_tpu_torch.tools.jamiolkowski import fast_jamiolkowski_iso_std
        rows = []
        for lbl, op in model.operations.items():
            choi = fast_jamiolkowski_iso_std(op.dense(), model.basis)
            evals = np.linalg.eigvalsh((choi + choi.conj().T) / 2)
            rows.append([str(lbl),
                         ', '.join('%.4g' % v for v in sorted(evals)[::-1])])
        return WorkspaceTable(self, _table_html(['Gate', 'Choi eigenvalues'],
                                                rows))

    def GateEigenvalueTable(self, model, target_model=None):
        """Gate (and optionally target-gate) eigenvalues; with a target
        model a Target column and the eigenvalue discrepancies are added
        (reference workspacetables.GateEigenvalueTable)."""
        rows = []
        headers = ['Gate', 'Eigenvalues']
        if target_model is not None:
            headers += ['Target eigenvalues', 'max |ev diff|']
        for lbl, op in model.operations.items():
            ev = np.sort_complex(np.linalg.eigvals(op.dense()))
            row = [str(lbl), ', '.join(
                '%.4f%+.4fj' % (v.real, v.imag) for v in ev)]
            if target_model is not None:
                tev = np.sort_complex(np.linalg.eigvals(
                    target_model.operations[lbl].dense()))
                row.append(', '.join('%.4f%+.4fj' % (v.real, v.imag)
                                     for v in tev))
                # min-weight eigenvalue matching: independent sorts can
                # mispair near-conjugate eigenvalues (reference pairs via
                # _ot.minweight_match)
                from scipy.optimize import linear_sum_assignment
                cost = np.abs(ev[:, None] - tev[None, :])
                ri, ci = linear_sum_assignment(cost)
                row.append('%.4g' % float(np.max(cost[ri, ci])))
            rows.append(row)
        return WorkspaceTable(self, _table_html(headers, rows))

    def FitComparisonTable(self, max_lengths, circuit_structs, model_by_l,
                           dataset, objfn='logl'):
        from pygsti_tpu_torch.report.workspaceplots import per_circuit_2dlogl
        rows = []
        for L, struct, mdl in zip(max_lengths, circuit_structs, model_by_l):
            vals = per_circuit_2dlogl(mdl, dataset, list(struct), objfn, self.device)
            rows.append([L, '%.1f' % sum(vals.values()), len(vals)])
        return WorkspaceTable(self, _table_html(
            ['L', '2&Delta;log&#8467;', 'N circuits'], rows))

    # -- plots ----------------------------------------------------------------

    def ColorBoxPlot(self, plottype, circuit_struct, dataset, model,
                     typ='boxes'):
        from pygsti_tpu_torch.report.workspaceplots import (
            per_circuit_2dlogl, color_boxplot_html, scatter_plot_html,
            histogram_plot_html)
        objective = 'logl' if 'logl' in str(plottype) else 'chi2'
        vals = per_circuit_2dlogl(model, dataset, list(circuit_struct),
                                  objective, self.device)
        if typ == 'scatter':
            html = scatter_plot_html(vals, title=str(plottype), model=model)
        elif typ == 'histogram':
            html = histogram_plot_html(vals, title=str(plottype),
                                       model=model)
        else:
            html = color_boxplot_html(circuit_struct, vals,
                                      title=str(plottype), model=model)
        return WorkspacePlot(self, html)


class WorkspaceText(WorkspaceOutput):
    """A block of switchable text (reference: workspace.WorkspaceText)."""


class NotApplicable(WorkspaceOutput):
    """Marker output: the requested quantity is not applicable to the given
    arguments (reference: workspace.NotApplicable:1961)."""

    def __init__(self, ws):
        super().__init__(ws, "<center><i>N/A</i></center>")


class SwitchValue(object):
    """A value that depends on the position of one or more Switchboard
    switches: indexable by switch position, with a dense `base` array
    (reference: workspace.SwitchValue)."""

    def __init__(self, parent_switchboard, name, dependencies, shape=None):
        import numpy as _np
        self.parent = parent_switchboard
        self.name = name
        self.dependencies = tuple(dependencies)
        if shape is None:
            shape = tuple(len(parent_switchboard.switch_positions[d])
                          for d in self.dependencies)
        self.base = _np.empty(shape, dtype=object)

    def __getitem__(self, key):
        return self.base[key]

    def __setitem__(self, key, val):
        self.base[key] = val

    def __iter__(self):
        return iter(self.base.flat)


class SwitchboardView(object):
    """A view of (a subset of) another Switchboard's switches (reference:
    workspace.SwitchboardView)."""

    def __init__(self, switchboard, idsuffix="v", show="all"):
        self.switchboard = switchboard
        self.idsuffix = idsuffix
        self.show = show

    def render(self, typ='html'):
        return self.switchboard.render(typ)

    def __getattr__(self, attr):
        return getattr(self.__dict__['switchboard'], attr)


def random_id():
    """A random id string for HTML elements (reference:
    workspace.random_id)."""
    import random
    import string
    return ''.join(random.choice(string.ascii_lowercase + string.digits)
                   for _ in range(8))


def in_ipython_notebook():
    """Whether we are running inside an IPython/Jupyter notebook
    (reference: workspace.in_ipython_notebook)."""
    try:
        shell = get_ipython().__class__.__name__  # noqa: F821
        return shell == 'ZMQInteractiveShell'
    except NameError:
        return False


def display_ipynb(content):
    """Display HTML content in an IPython notebook (reference:
    workspace.display_ipynb)."""
    from IPython.core.display import display, HTML
    display(HTML(content))


def enable_plotly_pickling():
    """Monkeypatch plotly graph objects to support pickling (reference:
    workspace.enable_plotly_pickling).  Our reports render static HTML with
    no plotly dependency, so this is a no-op when plotly is absent."""
    try:
        import plotly.graph_objs as go  # noqa: F401
    except ImportError:
        return


def disable_plotly_pickling():
    """Undo :func:`enable_plotly_pickling` (reference:
    workspace.disable_plotly_pickling)."""
    try:
        import plotly.graph_objs as go  # noqa: F401
    except ImportError:
        return


def ws_custom_digest(md5, v):
    """Custom digest handler for workspace objects, used with
    :func:`pygsti_tpu_torch.baseobjs.smartcache.digest` (reference:
    workspace.ws_custom_digest)."""
    from pygsti_tpu_torch.baseobjs.smartcache import CustomDigestError
    if isinstance(v, WorkspaceOutput):
        md5.update(v.render().encode())
    elif hasattr(v, 'digest_hash'):
        md5.update(v.digest_hash())
    else:
        raise CustomDigestError()
