"""FOGI rate visualization (counterpart of pygsti_tpu/report/fogidiagram.py).

The first-order gauge-invariant error rates of a model with a FOGI store
(models/fogistore.py) as a self-contained HTML bar chart and table,
intrinsic against relational, with per-op intrinsic totals.
"""

from __future__ import annotations

import html as _html


class FOGIDiagram(object):
    """Renders a model's FOGI error rates.  The model must have had
    ``setup_fogi(...)`` run, or a FirstOrderGaugeInvariantStore is passed."""

    def __init__(self, model, fogi_store=None):
        self.model = model
        self.store = fogi_store if fogi_store is not None \
            else getattr(model, 'fogi_store', None)
        assert self.store is not None, \
            "Call model.setup_fogi(...) first or pass fogi_store"

    def rates_table(self):
        """List of (label, rate, kind) sorted by |rate| descending; kind is
        'intrinsic' for single-op quantities (no gauge-space direction) and
        'relational' otherwise."""
        store = self.store
        rates = self.model.fogi_errorgen_components_array(include_fogv=False)
        rows = []
        for k, meta in enumerate(store.fogi_metadata):
            kind = 'intrinsic' if meta['gaugespace_dir'] is None \
                else 'relational'
            rows.append((meta['name'], float(rates[k]), kind))
        rows.sort(key=lambda r: -abs(r[1]))
        return rows

    def aggregate_by_op(self):
        """{op_label: {'H': .., 'S': .., 'total': ..}} intrinsic error
        aggregates (model.fogi_contribution) of the primitive ops that
        carry error generators in the store."""
        out = {}
        for op_label in self.store.primitive_op_labels:
            if op_label not in self.store.elem_errorgen_labels_by_op:
                continue
            h = self.model.fogi_contribution(op_label, 'H', 'intrinsic')
            s = self.model.fogi_contribution(op_label, 'S', 'intrinsic')
            out[op_label] = {'H': h, 'S': s, 'total': 2 * h + s}
        return out

    def render_html(self, max_rows=50):
        rows = self.rates_table()[:max_rows]
        if rows:
            max_abs = max(abs(r[1]) for r in rows) or 1.0
        else:
            max_abs = 1.0
        out = ['<div class="fogi-diagram"><h3>FOGI error rates</h3>',
               '<table border="0" cellpadding="3">',
               '<tr><th>quantity</th><th>kind</th><th>rate</th>'
               '<th></th></tr>']
        for lbl, rate, kind in rows:
            width = int(200 * abs(rate) / max_abs)
            color = '#3366cc' if kind == 'intrinsic' else '#cc6633'
            out.append(
                '<tr><td><code>%s</code></td><td>%s</td>'
                '<td align="right">%.3e</td>'
                '<td><div style="background:%s;width:%dpx;height:10px">'
                '</div></td></tr>'
                % (_html.escape(lbl), kind, rate, color, width))
        out.append('</table>')
        agg = self.aggregate_by_op()
        if agg:
            out.append('<h4>Per-op intrinsic totals</h4><table border="0" '
                       'cellpadding="3"><tr><th>op</th><th>H</th><th>S</th>'
                       '<th>total</th></tr>')
            for op_label, vals in agg.items():
                out.append('<tr><td><code>%s</code></td>'
                           '<td>%.3e</td><td>%.3e</td><td>%.3e</td></tr>'
                           % (_html.escape(str(op_label)), vals['H'],
                              vals['S'], vals['total']))
            out.append('</table>')
        out.append('</div>')
        return '\n'.join(out)

    def write_html(self, path, max_rows=50):
        with open(path, 'w') as f:
            f.write('<html><body>%s</body></html>'
                    % self.render_html(max_rows))
