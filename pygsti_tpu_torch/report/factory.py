"""Report generation: single-file HTML GST reports (counterpart of
pygsti_tpu/report/factory.py).

The standard report holds the input summary, model violation, the
per-circuit box plot, the per-gate metric tables (with error bars when a
confidence level is given), eigenvalues, error-generator projections,
decompositions, SPAM tables, and the raw matrices.  A section that does not
apply to the results (instruments of a model without any, a box plot of a
design without plaquettes) is left out by a test of the results; a section
that fails raises.  With a confidence level the error bars come from the
estimate's Gauss-Newton Hessian, made on the estimate's device through the
blocked Jacobian's kernel, and a failure there raises too: no report is
written without the error bars it was asked for.
"""

from __future__ import annotations

import html as _html
import time

import numpy as np

from pygsti_tpu_torch.report import reportables as _rpt


def _maybe_auto_open(path, auto_open):
    """Open the written report in the default browser when asked."""
    if auto_open:
        import pathlib
        import webbrowser
        webbrowser.open(pathlib.Path(path).resolve().as_uri())


_CSS = """
body { font-family: -apple-system, 'Segoe UI', Helvetica, Arial, sans-serif;
       margin: 2em auto; max-width: 1100px; color: #222; }
h1 { border-bottom: 3px solid #4472c4; padding-bottom: .3em; }
h2 { color: #2f5496; margin-top: 2em; }
table { border-collapse: collapse; margin: 1em 0; }
th, td { border: 1px solid #bbb; padding: .45em .8em; text-align: right; }
th { background: #4472c4; color: white; }
tr:nth-child(even) { background: #f2f6fc; }
td.lbl { text-align: left; font-family: monospace; }
.good { color: #1a7a2a; } .bad { color: #b02020; font-weight: bold; }
.matrix { font-family: monospace; font-size: 0.85em; white-space: pre; }
.meta { color: #666; font-size: .9em; }
"""


def _fmt(v, prec=6):
    if isinstance(v, tuple) and len(v) == 2:  # (value, errorbar)
        return "%s &plusmn; %s" % (_fmt(v[0], prec), _fmt(v[1], 2))
    if isinstance(v, complex):
        return "%.4g%+.4gj" % (v.real, v.imag)
    if isinstance(v, float):
        return "%.*g" % (prec, v)
    return _html.escape(str(v))


def _table(headers, rows):
    out = ["<table><tr>"] + ["<th>%s</th>" % _html.escape(str(h)) for h in headers] \
        + ["</tr>"]
    for row in rows:
        out.append("<tr>")
        for i, cell in enumerate(row):
            cls = ' class="lbl"' if i == 0 else ''
            out.append("<td%s>%s</td>" % (cls, cell if isinstance(cell, str) else _fmt(cell)))
        out.append("</tr>")
    out.append("</table>")
    return "".join(out)


def _matrix_html(m, prec=4):
    m = np.asarray(m)
    if np.iscomplexobj(m) and np.allclose(m.imag, 0, atol=1e-10):
        m = m.real
    return '<div class="matrix">%s</div>' % _html.escape(
        np.array2string(m, precision=prec, suppress_small=True, max_line_width=200))


def _display_key(est):
    """The model a report shows: the last gauge-optimized variant, else the
    final iteration's estimate."""
    key = 'final iteration estimate'
    for k in est.models:
        if k not in ('target', 'seed', 'final iteration estimate') \
                and not k.startswith('iteration'):
            key = k
    return key


def construct_standard_report(results, title="GST Report", confidence_level=None,
                              comm=None, ws=None, advanced_options=None, verbosity=1):
    """A Report of GST results.  Each estimate's Hessian and box plot are
    computed on the estimate's device."""
    return Report(results, title, confidence_level)


class Report(object):
    """Renders GST results to a self-contained HTML file.

    After ``write_html``, ``seconds`` holds the host-clock seconds of its
    steps ('hessian', 'projection', 'error bars', 'box plot', 'rest') summed
    over the estimates, and ``box_values[estimate key]`` the box plot's
    per-circuit values."""

    def __init__(self, results, title="GST Report", confidence_level=None):
        self.results = results
        self.title = title
        self.confidence_level = confidence_level
        self.seconds = {}
        self.box_values = {}

    def _timed(self, step, fn):
        t0 = time.perf_counter()
        out = fn()
        self.seconds[step] = self.seconds.get(step, 0.0) + time.perf_counter() - t0
        return out

    def _estimate_sections(self, est_key, est):
        from pygsti_tpu_torch.circuits.circuitstructure import PlaquetteGridCircuitStructure
        from pygsti_tpu_torch.report.workspaceplots import (model_violation_boxplot_html,
                                                            per_circuit_2dlogl)
        results = self.results
        sections = ["<h2>Estimate: %s</h2>" % _html.escape(str(est_key))]

        # -- model violation -----------------------------------------------
        mv = _rpt.model_violation_table(results, est_key)
        nsig = mv.get('n_sigma')
        cls = 'good' if (nsig is not None and nsig < 2) else 'bad'
        rows = [["2&Delta;log&#8467;", _fmt(mv.get('final_2dlogl'))],
                ["k (degrees of freedom)", _fmt(mv.get('final_dof'))],
                ["N<sub>sigma</sub>", '<span class="%s">%s</span>' % (cls, _fmt(nsig, 3))]]
        sections.append("<h3>Model violation</h3>")
        sections.append(_table(["Quantity", "Value"], rows))

        # -- fit progression (per-iteration objective values) ----------------
        raw_vals = est.parameters.get('raw_objective_values')
        if raw_vals:
            rows = [["iteration %d" % i] + [_fmt(float(v)) for v in vals]
                    for i, vals in enumerate(raw_vals)]
            ncol = max(len(v) for v in raw_vals)
            sections.append("<h3>Fit progression (objective per stage)</h3>")
            sections.append(_table(["Iteration"] + ["stage %d" % j for j in range(ncol)], rows))

        # -- unmodeled (wildcard) error --------------------------------------
        budget = est.parameters.get('unmodeled_error')
        if budget is not None:
            rows = [[str(lbl), _fmt(float(w))] for lbl, w in budget.description().items()]
            sections.append("<h3>Un-modeled error (wildcard budget)</h3>")
            sections.append(_table(["Primitive op", "TVD budget"], rows))

        # -- per-circuit color box plot --------------------------------------
        edesign = getattr(results.data, 'edesign', None)
        lists = getattr(edesign, 'circuit_lists', None)
        struct = lists[-1] if lists else None
        ds = getattr(results.data, 'dataset', None)
        final_mdl = est.models.get('final iteration estimate')
        if isinstance(struct, PlaquetteGridCircuitStructure) and ds is not None \
                and final_mdl is not None:
            def box():
                vals = per_circuit_2dlogl(final_mdl, ds, list(struct), 'logl', est.device)
                self.box_values[est_key] = vals
                return model_violation_boxplot_html(final_mdl, ds, struct, values=vals)
            sections.append(self._timed('box plot', box))

        target = est.models.get('target')
        display_key = _display_key(est)
        model = est.models.get(display_key)
        if model is None or target is None:
            return sections
        sections.append('<p class="meta">Displayed model: %s</p>' % _html.escape(display_key))

        # -- confidence region (optional) ------------------------------------
        crf_view = None
        if self.confidence_level is not None:
            crf = est.create_confidence_region_factory()
            self._timed('hessian', lambda: crf.compute_hessian(approximate=True))
            self._timed('projection', crf.project_hessian)
            crf_view = crf.view(self.confidence_level)

        # -- per-gate metrics (with error bars under a confidence region) ----
        t0 = time.perf_counter()
        gm = _rpt.gate_metrics_table(
            model, target,
            metrics=('entanglement_infidelity', 'avg_gate_infidelity',
                     'half_diamond_norm', 'jtrace_diff', 'frobenius_diff',
                     'eigenvalue_entanglement_infidelity',
                     'nonunitary_entanglement_infidelity',
                     'generator_infidelity', 'unitarity'),
            crf_view=crf_view)
        sm = _rpt.spam_metrics_table(model, target, crf_view=crf_view)
        self.seconds['error bars'] = self.seconds.get('error bars', 0.0) \
            + time.perf_counter() - t0
        if gm:
            metrics = list(next(iter(gm.values())).keys())
            rows = [[str(lbl)] + [row[m] for m in metrics] for lbl, row in gm.items()]
            sections.append("<h3>Per-gate metrics vs target</h3>")
            sections.append(_table(["Gate"] + metrics, rows))

        # -- model-level metrics ---------------------------------------------
        rows = [["average gateset infidelity",
                 _fmt(_rpt.average_gateset_infidelity(model, target))],
                ["predicted RB number r", _fmt(_rpt.predicted_rb_number(model, target))]]
        sections.append("<h3>Model-level metrics</h3>")
        sections.append(_table(["Quantity", "Value"], rows))

        # -- gauge-invariant: eigenvalues and germ-amplified metrics ---------
        sections.append("<h3>Gate eigenvalues (gauge-invariant)</h3>")
        rows = []
        for lbl in model.operations:
            g = model.operations[lbl].dense()
            ev = _rpt.eigenvalues(g)
            rel = _rpt.rel_eigenvalues(g, target.operations[lbl].dense(), model.basis) \
                if lbl in target.operations else []
            rows.append([str(lbl),
                         ", ".join(_fmt(v, 4) for v in sorted(ev, key=lambda z: -abs(z))[:8]),
                         ", ".join(_fmt(v, 4) for v in sorted(rel, key=lambda z: -abs(z))[:8])])
        sections.append(_table(["Gate", "eigenvalues", "relative (T^-1 G) eigenvalues"], rows))

        angles = _rpt.angles_btwn_rotn_axes(model)
        op_lbls = [str(lbl) for lbl in model.operations]
        rows = [[op_lbls[i]] + [_fmt(angles[i, j], 3) for j in range(len(op_lbls))]
                for i in range(len(op_lbls))]
        sections.append("<h3>Angles between rotation axes (/&pi;)</h3>")
        sections.append(_table(["Gate"] + op_lbls, rows))

        germs = list(getattr(edesign, 'germs', []) or [])
        if germs:
            ga = _rpt.germ_amplified_metrics_table(model, target, germs)
            rows = [[g.str, _fmt(d['eigenvalue_entanglement_infidelity']),
                     _fmt(d['eigenvalue_diamondnorm'])] for g, d in ga.items()]
            sections.append("<h3>Germ-amplified metrics (gauge-invariant)</h3>")
            sections.append(_table(["Germ", "eigenvalue ent. infidelity",
                                    "eigenvalue 1/2 diamond dist"], rows))

        # -- error-generator projections -------------------------------------
        eg = _rpt.errorgen_projections_table(model, target)
        if eg:
            rows = []
            for lbl, d in eg.items():
                H = d['hamiltonian projections']
                S = d['stochastic projections']
                A = d['affine projections']
                rows.append([str(lbl), _fmt(float(np.linalg.norm(H))), _fmt(float(np.sum(S))),
                             _fmt(float(np.linalg.norm(A))),
                             ", ".join(_fmt(v, 3) for v in H[:6]),
                             ", ".join(_fmt(v, 3) for v in S[:6])])
            sections.append("<h3>Error-generator projections (logGTi)</h3>")
            sections.append(_table(["Gate", "|H|", "&Sigma;S", "|A|", "H projections",
                                    "S projections"], rows))

        # -- gate decompositions ---------------------------------------------
        gd = _rpt.gate_decomposition_table(model, target)
        rows = []
        for lbl, d in gd.items():
            dec = d['decomposition']
            rows.append([str(lbl), _fmt(dec.get('pi rotations', np.nan), 4),
                         _fmt(d['choi_trace'], 4), _fmt(d['upper_bound_fidelity'], 6),
                         _fmt(d['maximum_fidelity'], 6), _fmt(d['maximum_trace_dist'], 4),
                         ", ".join(_fmt(v, 3) for v in d['choi_eigenvalues'][-4:])])
        sections.append("<h3>Gate decompositions &amp; Choi spectra</h3>")
        sections.append(_table(["Gate", "rotation (/&pi;)", "Choi trace",
                                "upper-bound fidelity", "max fidelity w/unitary",
                                "max trace dist", "top Choi eigenvalues"], rows))

        # -- SPAM metrics (with error bars) ----------------------------------
        if sm:
            cols = list(next(iter(sm.values())).keys())
            rows = [["%s %s" % (kind, lbl)] + [d.get(c, '') for c in cols]
                    for (kind, lbl), d in sm.items()]
            sections.append("<h3>SPAM metrics vs target</h3>")
            sections.append(_table(["Item"] + cols, rows))

        # -- SPAM probabilities ----------------------------------------------
        dots = _rpt.spam_dotprods(list(model.preps.values()), list(model.povms.values()))
        eff_lbls = [e for povm in model.povms.values() for e in povm.outcome_labels]
        rows = [[str(eff_lbls[j])] + [_fmt(dots[j, i], 5) for i in range(dots.shape[1])]
                for j in range(dots.shape[0])]
        sections.append("<h3>SPAM probabilities &lt;E|&rho;&gt;</h3>")
        sections.append(_table(["Effect"] + [str(p) for p in model.preps], rows))

        # -- instruments -----------------------------------------------------
        if len(getattr(model, 'instruments', ())):
            rows = [[str(ilbl), _fmt(_rpt.instrument_infidelity(model, target, ilbl)),
                     _fmt(_rpt.instrument_half_diamond_norm(model, target, ilbl))]
                    for ilbl in model.instruments]
            sections.append("<h3>Instrument metrics vs target</h3>")
            sections.append(_table(["Instrument", "infidelity", "1/2 diamond dist"], rows))

        # -- gate matrices ---------------------------------------------------
        sections.append("<h3>Estimated gate matrices (%s basis)</h3>"
                        % getattr(model.basis, 'name', 'pp'))
        for lbl in model.operations:
            sections.append("<h4>%s</h4>" % _html.escape(str(lbl)))
            sections.append(_matrix_html(model.operations[lbl].dense()))

        # -- SPAM vectors ----------------------------------------------------
        sections.append("<h3>SPAM vectors</h3>")
        for lbl in model.preps:
            sections.append("<h4>prep %s</h4>" % _html.escape(str(lbl)))
            sections.append(_matrix_html(model.preps[lbl].dense().reshape(1, -1)))
        for lbl in model.povms:
            sections.append("<h4>povm %s</h4>" % _html.escape(str(lbl)))
            sections.append(_matrix_html(model.povms[lbl].dense()))
        return sections

    def write_html(self, path, auto_open=False, verbosity=1):
        t_start = time.perf_counter()
        self.seconds = {}
        results = self.results
        sections = ["<h1>%s</h1>" % _html.escape(self.title)]

        # -- input summary -----------------------------------------------------
        sections.append("<h2>Input summary</h2>")
        edesign = results.data.edesign
        ds = results.data.dataset
        rows = []
        if hasattr(edesign, 'circuit_lists'):
            for i, cl in enumerate(edesign.circuit_lists):
                rows.append(["iteration %d" % i, len(list(cl))])
        rows.append(["dataset circuits", len(list(ds.keys()))])
        rows.append(["total counts", _fmt(float(sum(ds[c].total for c in ds.keys())))])
        rows.append(["outcome labels", _html.escape(str(ds.outcome_labels))])
        sections.append(_table(["Quantity", "Value"], rows))

        chunks = {key: self._estimate_sections(key, est)
                  for key, est in results.estimates.items()}
        if len(chunks) > 1:
            # several estimates: one switchboard toggles between them
            from pygsti_tpu_torch.report.workspace import Workspace
            sb = Workspace().Switchboard(['Estimate'], [list(chunks)])
            for key, chunk in chunks.items():
                sb.add(str(key), "\n".join(chunk))
            sections.append(sb.render())
        else:
            for chunk in chunks.values():
                sections.extend(chunk)

        # -- meta ----------------------------------------------------------------
        import pygsti_tpu_torch
        sections.append("<h2>Metadata</h2>")
        rows = [["%s fit wall-clock (s)" % key, _fmt(est.parameters['fit_time'], 4)]
                for key, est in results.estimates.items() if 'fit_time' in est.parameters]
        rows.append(["pygsti_tpu_torch version", pygsti_tpu_torch.__version__])
        sections.append(_table(["Quantity", "Value"], rows))

        doc = ("<!DOCTYPE html><html><head><meta charset='utf-8'><title>%s</title>"
               "<style>%s</style></head><body>%s</body></html>"
               % (_html.escape(self.title), _CSS, "\n".join(sections)))
        with open(path, 'w') as f:
            f.write(doc)
        self.seconds['rest'] = time.perf_counter() - t_start - sum(self.seconds.values())
        _maybe_auto_open(path, auto_open)
        return path

    def write_pdf(self, path, verbosity=1, **kwargs):
        """A PDF of the report's text summary: through pdflatex where it is
        installed, else the built-in text-only PDF writer."""
        import os
        import shutil
        import subprocess
        import tempfile
        lines = self._text_summary_lines()
        latex = shutil.which('pdflatex')
        if latex:
            tex = "\\documentclass{article}\\usepackage[margin=1in]{geometry}" \
                  "\\begin{document}\\begin{verbatim}\n" \
                  + "\n".join(lines) + "\n\\end{verbatim}\\end{document}\n"
            with tempfile.TemporaryDirectory() as td:
                with open(os.path.join(td, 'report.tex'), 'w') as f:
                    f.write(tex)
                res = subprocess.run([latex, '-interaction=nonstopmode', 'report.tex'],
                                     cwd=td, capture_output=True, timeout=300)
                pdf = os.path.join(td, 'report.pdf')
                if res.returncode != 0 or not os.path.exists(pdf):
                    raise RuntimeError("pdflatex failed: %s"
                                       % res.stdout.decode(errors='replace')[-2000:])
                shutil.copy(pdf, path)
                return path
        _write_minimal_pdf(path, self.title, lines)
        return path

    def _text_summary_lines(self):
        """The report's plain-text summary (the PDF's content)."""
        results = self.results
        lines = [self.title, "=" * len(self.title), ""]
        for est_key, est in results.estimates.items():
            lines.append("Estimate: %s" % est_key)
            mv = _rpt.model_violation_table(results, est_key)
            lines.append("  2*DeltaLogL = %s   k = %s   Nsigma = %s"
                         % (mv.get('final_2dlogl'), mv.get('final_dof'), mv.get('n_sigma')))
            target = est.models.get('target')
            display_key = _display_key(est)
            model = est.models.get(display_key)
            if model is None or target is None:
                lines.append("")
                continue
            lines.append("  displayed model: %s" % display_key)
            for lbl, row in _rpt.gate_metrics_table(model, target).items():
                metr = "  ".join("%s=%.3g" % (m, v) for m, v in row.items()
                                 if isinstance(v, (int, float)))
                lines.append("  %-16s %s" % (lbl, metr))
            lines.append("")
        return lines


def _write_minimal_pdf(path, title, lines, font_size=9, leading=11):
    """Text-only PDF writer (PDF 1.4, Courier): a valid multi-page PDF
    without LaTeX."""
    per_page = int(720 / leading)
    pages = [lines[i:i + per_page] for i in range(0, max(len(lines), 1), per_page)]

    def esc(s):
        return s.replace('\\', r'\\').replace('(', r'\(').replace(')', r'\)')

    objects = []  # (obj_num, bytes)
    n_pages = len(pages)
    # 1 = catalog, 2 = pages tree, 3 = font; pages start at 4
    page_obj_nums = [4 + 2 * i for i in range(n_pages)]
    objects.append((1, b"<< /Type /Catalog /Pages 2 0 R >>"))
    kids = " ".join("%d 0 R" % n for n in page_obj_nums)
    objects.append((2, ("<< /Type /Pages /Kids [%s] /Count %d >>" % (kids, n_pages)).encode()))
    objects.append((3, b"<< /Type /Font /Subtype /Type1 /BaseFont /Courier >>"))
    for i, page_lines in enumerate(pages):
        content = ["BT /F1 %d Tf 36 756 Td %d TL" % (font_size, leading)]
        content.extend("(%s) Tj T*" % esc(ln) for ln in page_lines)
        content.append("ET")
        stream = "\n".join(content).encode('latin-1', 'replace')
        objects.append((page_obj_nums[i],
                        ("<< /Type /Page /Parent 2 0 R /MediaBox [0 0 612 792] "
                         "/Resources << /Font << /F1 3 0 R >> >> /Contents %d 0 R >>"
                         % (page_obj_nums[i] + 1)).encode()))
        objects.append((page_obj_nums[i] + 1,
                        b"<< /Length " + str(len(stream)).encode() + b" >>\n"
                        b"stream\n" + stream + b"\nendstream"))

    out = bytearray(b"%PDF-1.4\n")
    offsets = {}
    for num, body in sorted(objects):
        offsets[num] = len(out)
        out += ("%d 0 obj\n" % num).encode() + body + b"\nendobj\n"
    xref_pos = len(out)
    max_obj = max(offsets) + 1
    out += ("xref\n0 %d\n" % max_obj).encode()
    out += b"0000000000 65535 f \n"
    for n in range(1, max_obj):
        out += (("%010d 00000 n \n" % offsets[n]).encode()
                if n in offsets else b"0000000000 65535 f \n")
    out += ("trailer\n<< /Size %d /Root 1 0 R >>\nstartxref\n%d\n%%%%EOF\n"
            % (max_obj, xref_pos)).encode()
    with open(path, 'wb') as f:
        f.write(bytes(out))
    return path


def create_report_notebook(results, filename, title="GST Report Notebook",
                           confidence_level=None, auto_open=False, connected=False,
                           verbosity=0):
    """Write a Jupyter notebook that loads `results` and renders the
    standard report's tables and plots through the Workspace.  The results
    are written to ``<filename minus .ipynb>_results/``, which the notebook
    reads; `confidence_level` adds a cell that builds the confidence region
    on the card.  `connected` is accepted for pyGSTi's signature (the
    notebook embeds no JavaScript either way)."""
    import json as _json
    import os as _os

    results_dir = _os.path.splitext(filename)[0] + '_results'
    if results is not None:
        results.write(results_dir)

    def code(src):
        return {"cell_type": "code", "execution_count": None,
                "metadata": {}, "outputs": [], "source": src}

    def md(src):
        return {"cell_type": "markdown", "metadata": {}, "source": src}

    cells = [
        md("# %s\n\nGenerated by pygsti_tpu_torch." % title),
        code("from pygsti_tpu_torch.protocols.gst import ModelEstimateResults\n"
             "from pygsti_tpu_torch.report.workspace import Workspace\n"
             "ws = Workspace()"),
        md("## Load results"),
        code("results = ModelEstimateResults.from_dir(%r)\n"
             "est = results.estimates[list(results.estimates.keys())[0]]\n"
             "target = est.models['target']\n"
             "final = est.models.get('stdgaugeopt', "
             "est.models['final iteration estimate'])" % results_dir),
        md("## Gate metrics vs. target"),
        code("ws.GatesVsTargetTable(final, target)"),
        md("## SPAM metrics"),
        code("ws.SpamVsTargetTable(final, target)"),
        md("## Gate matrices"),
        code("ws.GatesTable(final)"),
        md("## Choi eigenvalues"),
        code("ws.ChoiTable(final)"),
        md("## Per-circuit model violation"),
        code("struct = results.data.edesign.circuit_lists[-1]\n"
             "ws.ColorBoxPlot('logl', struct, results.data.dataset, final)"),
    ]
    if confidence_level is not None:
        cells.extend([
            md("## Confidence regions (%g%% level)" % confidence_level),
            code("crf = est.create_confidence_region_factory()\n"
                 "crf.compute_hessian(approximate=True)\n"
                 "crf_view = crf.view(%g)\n"
                 "ws.GatesVsTargetTable(final, target, crf_view)" % confidence_level),
        ])
    nb = {"cells": cells,
          "metadata": {"kernelspec": {"display_name": "Python 3", "language": "python",
                                      "name": "python3"}},
          "nbformat": 4, "nbformat_minor": 5}
    with open(filename, 'w') as f:
        _json.dump(nb, f, indent=1)
    _maybe_auto_open(filename, auto_open)
    return filename


def construct_nqnoise_report(results, title="auto", confidence_level=None, verbosity=1,
                             **kwargs):
    """The standard report of implicit (n-qubit noise) model estimates,
    which render through the same pipeline."""
    if title == "auto":
        title = "N-Qubit Noise Report"
    return construct_standard_report(results, title, confidence_level=confidence_level,
                                     verbosity=verbosity, **kwargs)


def basis_aware_display(models, name, ordinary, leakage, metric_space=0):
    """The column tuple a gates-vs-target table shows for a model: the
    `leakage` (subspace) columns for a model whose basis implies leakage
    modeling when `metric_space` is 0 ("Subspace"), else the `ordinary`
    ones; a dict of them for a dict of models."""
    def _choose(mdl):
        basis = getattr(mdl, 'basis', None)
        leaky = basis is not None and \
            bool(getattr(basis, 'implies_leakage_modeling', lambda: False)())
        return leakage if (metric_space == 0 and leaky) else ordinary
    if isinstance(models, dict):
        return {k: _choose(m) for k, m in models.items()}
    return _choose(models)


def create_drift_report(results, title="auto", verbosity=1, **kwargs):
    """Drift (stability analysis) report of StabilityAnalysisResults."""
    from pygsti_tpu_torch.report.driftreport import DriftReport
    if title == "auto" or title is None:
        title = "Drift Report"
    return DriftReport(results, title)


def create_offline_zip(output_dir="."):
    """Zip the reports (HTML and PDF files) under `output_dir` into
    ``offline.zip`` there; each report is one self-contained file."""
    import os
    import zipfile
    out_path = os.path.join(str(output_dir), 'offline.zip')
    with zipfile.ZipFile(out_path, 'w', zipfile.ZIP_DEFLATED) as z:
        for root, _, files in os.walk(str(output_dir)):
            for fn in files:
                if fn.endswith(('.html', '.pdf')):
                    full = os.path.join(root, fn)
                    z.write(full, os.path.relpath(full, str(output_dir)))
    return out_path


_CLIFFORD_PACKS = ['smq1Q_XYI', 'smq1Q_XY', 'smq1Q_XZ', 'smq1Q_XYZI', 'smq1Q_ZN',
                   'smq1Q_pi4_pi2_XZ', 'smq2Q_XYICNOT', 'smq2Q_XYCNOT', 'smq2Q_XYICPHASE',
                   'smq2Q_XYCPHASE', 'smq2Q_XYI', 'smq2Q_XY']


def find_std_clifford_compilation(model, verbosity=0):
    """The Clifford compilation of the standard model pack whose target has
    `model`'s gate set, or None."""
    import importlib
    from pygsti_tpu_torch.models.explicitmodel import ExplicitOpModel
    if not isinstance(model, ExplicitOpModel):
        return None
    my_ops = {str(k) for k in model.operations.keys()}
    for name in _CLIFFORD_PACKS:
        pack = importlib.import_module('pygsti_tpu_torch.modelpacks.' + name)
        if {str(k) for k in pack.target_model('static').operations.keys()} == my_ops:
            getter = getattr(pack, 'clifford_compilation', None) or \
                pack._Pack.clifford_compilation
            return getter()
    return None
