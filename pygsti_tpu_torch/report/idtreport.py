"""Idle tomography HTML report (counterpart of
pygsti_tpu/report/idtreport.py).

One self-contained HTML file: the intrinsic-rate tables per qubit, the
correlated pair rates, and the observed <P>-vs-L decays (inline SVG).
"""

from __future__ import annotations

import html as _html
import itertools

from pygsti_tpu_torch.report.driftreport import _svg_line_plot
from pygsti_tpu_torch.report.factory import _maybe_auto_open


def _expectation(ds, circ, idxs):
    row = ds[circ]
    total = row.total
    if total <= 0:
        return 0.0
    exp = 0.0
    for outcome, cnt in row.counts.items():
        bits = outcome[0]
        par = sum(int(bits[i]) for i in idxs) % 2
        exp += (1 - 2 * par) * cnt
    return exp / total


def _rate_table_html(title, rates, keyfmt=str):
    rows = ['<tr><th>error</th><th>rate</th></tr>']
    for k, v in rates.items():
        rows.append('<tr><td>%s</td><td>%.3e</td></tr>'
                    % (_html.escape(keyfmt(k)), float(v)))
    return ('<h3>%s</h3><table border="1" cellpadding="4" '
            'style="border-collapse:collapse">%s</table>'
            % (_html.escape(title), ''.join(rows)))


class IdleTomographyReport(object):
    """Renderable idle-tomography report; `write_html(path)` emits one
    self-contained file."""

    def __init__(self, results, title="Idle Tomography Report"):
        self.results = results
        self.title = title

    def _render(self):
        res = self.results
        design = res.data.edesign
        ds = res.data.dataset
        qpos = {q: i for i, q in enumerate(design.qubit_labels_list)}
        Ns = list(design.max_lengths)

        parts = ['<!DOCTYPE html><html><head><meta charset="utf-8">'
                 '<title>%s</title></head><body style="font-family:sans-serif'
                 ';max-width:1000px;margin:auto">' % _html.escape(self.title),
                 '<h1>%s</h1>' % _html.escape(self.title),
                 '<p>%d qubits; max lengths %s</p>'
                 % (len(design.qubit_labels_list), Ns)]

        for q in design.qubit_labels_list:
            parts.append('<h2>Qubit %s</h2>' % _html.escape(str(q)))
            main = {k: v for k, v in res.intrinsic_rates[q].items()
                    if isinstance(k, tuple)}
            parts.append(_rate_table_html(
                'Intrinsic rates', main,
                keyfmt=lambda k: '%s(%s)' % (k[0], k[1])))
            # observed decay curves <P> vs L for matched prep/meas bases
            ys_list, labels = [], []
            for prep_p, meas_p in itertools.product('XYZ', 'XYZ'):
                if prep_p != meas_p:
                    continue
                keys = [(q, prep_p, meas_p, N) for N in Ns]
                if not all(k in design.circuit_table for k in keys):
                    continue
                vals = [_expectation(ds, design.circuit_table[k], [qpos[q]]) for k in keys]
                ys_list.append([v - min(0.0, min(vals)) for v in vals])
                labels.append('%s-basis' % prep_p)
            if ys_list:
                parts.append('<h3>Observed expectation decays</h3>')
                parts.append(_svg_line_plot(
                    ys_list, labels=labels,
                    title='&lt;P&gt; vs idle repetitions (qubit %s)' % q))
            slopes = res.observed_slopes.get(q, {})
            if slopes:
                parts.append(_rate_table_html(
                    'Observed slopes d&lt;meas&gt;/dL', slopes,
                    keyfmt=lambda k: 'prep %s / meas %s' % k))

        if res.pair_rates:
            parts.append('<h2>Correlated (weight-2) stochastic rates</h2>')
            for pair, rates in res.pair_rates.items():
                big = {k: v for k, v in rates.items() if abs(v) > 1e-6}
                parts.append(_rate_table_html(
                    'Pair %s' % (pair,), big,
                    keyfmt=lambda k: 'S(%s%s)' % (k[1][0], k[1][1])))

        parts.append('</body></html>')
        return '\n'.join(parts)

    def write_html(self, path, auto_open=False, verbosity=0):
        html_str = self._render()
        with open(path, 'w') as f:
            f.write(html_str)
        _maybe_auto_open(path, auto_open)
        return path


def create_idletomography_report(results, filename, title="auto",
                                 ws=None, auto_open=False, link_to=None,
                                 brevity=0, advanced_options=None,
                                 verbosity=1):
    """Create an idle tomography report and write it to `filename` (when
    not None)."""
    if title == "auto" or title is None:
        title = "Idle Tomography Report"
    report = IdleTomographyReport(results, title)
    if filename is not None:
        report.write_html(filename, auto_open=auto_open, verbosity=verbosity)
    return report
