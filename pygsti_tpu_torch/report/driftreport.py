"""Drift (stability analysis) HTML report (counterpart of
pygsti_tpu/report/driftreport.py).

The detection summary, per-circuit power spectra (inline SVG) and the
estimated probability trajectories of the drifting circuits, as one
self-contained HTML file.
"""

from __future__ import annotations

import html as _html

import numpy as np


from pygsti_tpu_torch.report.factory import _maybe_auto_open


def _svg_line_plot(ys_list, labels=None, width=560, height=180,
                   hline=None, title=''):
    """Tiny inline-SVG multi-line plot."""
    all_vals = [v for ys in ys_list for v in ys if np.isfinite(v)]
    if hline is not None:
        all_vals.append(hline)
    ymax = max(all_vals) * 1.05 if all_vals else 1.0
    ymin = 0.0
    n = max(len(ys) for ys in ys_list) if ys_list else 1
    colors = ['#d62728', '#1f77b4', '#2ca02c', '#9467bd', '#8c564b']

    def pt(i, v):
        x = 40 + (width - 50) * i / max(n - 1, 1)
        y = height - 20 - (height - 30) * (v - ymin) / (ymax - ymin)
        return '%.1f,%.1f' % (x, y)

    parts = ['<svg width="%d" height="%d" style="background:#fff;'
             'border:1px solid #ccc">' % (width, height)]
    if title:
        parts.append('<text x="%d" y="12" font-size="11" text-anchor="middle">'
                     '%s</text>' % (width // 2, _html.escape(title)))
    # axes
    parts.append('<line x1="40" y1="%d" x2="%d" y2="%d" stroke="#888"/>'
                 % (height - 20, width - 10, height - 20))
    parts.append('<line x1="40" y1="10" x2="40" y2="%d" stroke="#888"/>'
                 % (height - 20))
    parts.append('<text x="4" y="%d" font-size="9">%.2g</text>'
                 % (height - 20, ymin))
    parts.append('<text x="4" y="18" font-size="9">%.2g</text>' % ymax)
    if hline is not None:
        y = height - 20 - (height - 30) * (hline - ymin) / (ymax - ymin)
        parts.append('<line x1="40" y1="%.1f" x2="%d" y2="%.1f" '
                     'stroke="#444" stroke-dasharray="4,3"/>'
                     % (y, width - 10, y))
        parts.append('<text x="%d" y="%.1f" font-size="9">threshold</text>'
                     % (width - 65, y - 3))
    for ci, ys in enumerate(ys_list):
        pts = ' '.join(pt(i, v) for i, v in enumerate(ys) if np.isfinite(v))
        lbl = labels[ci] if labels else ''
        parts.append('<polyline points="%s" fill="none" stroke="%s" '
                     'stroke-width="1.3"><title>%s</title></polyline>'
                     % (pts, colors[ci % len(colors)], _html.escape(str(lbl))))
    parts.append('</svg>')
    return ''.join(parts)


def construct_drift_report(results, title="Drift Report"):
    """A DriftReport of StabilityAnalysisResults."""
    return DriftReport(results, title)


class DriftReport(object):
    """Self-contained HTML drift report from StabilityAnalysisResults."""

    def __init__(self, results, title="Drift Report"):
        self.results = results
        self.title = title

    def write_html(self, path, auto_open=False, verbosity=1):
        from pygsti_tpu_torch.extras.drift import signal as _sig
        res = self.results
        analyzer = res.stabilityanalyzer
        sections = ['<h1>%s</h1>' % _html.escape(self.title)]

        detected = res.instability_detected
        sections.append('<h2>Detection summary</h2>')
        sections.append('<p>Instability detected: <b style="color:%s">%s'
                        '</b></p>' % ('#c00' if detected else '#080',
                                      'YES' if detected else 'no'))
        sections.append('<p>%d circuits analyzed; %d drifting.</p>'
                        % (len(set(k[0] if isinstance(k, tuple) else k
                                   for k in analyzer.spectra)),
                           len(res.unstable_circuits)))

        if res.unstable_circuits:
            rows = []
            for c in res.unstable_circuits:
                freqs = analyzer.drift_frequencies.get(c, {})
                ftxt = '; '.join('%s: modes %s' % (o, m)
                                 for o, m in freqs.items()) \
                    if isinstance(freqs, dict) else str(freqs)
                rows.append('<tr><td style="font-family:monospace">%s</td>'
                            '<td>%s</td></tr>'
                            % (_html.escape(c.str), _html.escape(ftxt)))
            sections.append('<h2>Drifting circuits</h2>')
            sections.append('<table border="1" cellspacing="0" '
                            'cellpadding="3"><tr><th>Circuit</th>'
                            '<th>Significant modes</th></tr>%s</table>'
                            % ''.join(rows))

        # spectra plots for the (up to 12) most drifting circuits
        sections.append('<h2>Power spectra</h2>')
        shown = 0
        for key, spectrum in analyzer.spectra.items():
            if spectrum is None:
                continue
            c = key[0] if isinstance(key, tuple) else key
            if res.unstable_circuits and c not in res.unstable_circuits:
                continue
            T = len(spectrum)
            thresh = _sig.power_significance_threshold(
                analyzer.significance, max(T - 1, 1))
            sections.append(_svg_line_plot(
                [list(spectrum)], labels=[str(key)], hline=thresh,
                title=c.str if hasattr(c, 'str') else str(key)))
            shown += 1
            if shown >= 12:
                break
        if shown == 0:
            sections.append('<p>(no spectra to display)</p>')

        # probability trajectories
        if res.probability_trajectories:
            sections.append('<h2>Estimated probability trajectories</h2>')
            for (c, o), traj in list(res.probability_trajectories.items())[:8]:
                sections.append(_svg_line_plot(
                    [list(traj)], labels=['p(%s)' % str(o)],
                    title='%s : p(%s)' % (c.str, str(o))))

        doc = ('<!DOCTYPE html><html><head><meta charset="utf-8"><title>%s'
               '</title><style>body{font-family:sans-serif;margin:18px}'
               'table{border-collapse:collapse}</style></head><body>%s'
               '</body></html>'
               % (_html.escape(self.title), '\n'.join(sections)))
        with open(path, 'w') as f:
            f.write(doc)
        _maybe_auto_open(path, auto_open)
        return path
