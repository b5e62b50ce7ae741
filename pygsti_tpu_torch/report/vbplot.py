"""Volumetric-benchmark plots (counterpart of pygsti_tpu/report/vbplot.py):
depth x width data of a VBDataFrame (protocols/vbdataframe.py) as a
self-contained HTML color grid, and the capability region's boundary.
"""

from __future__ import annotations

import html as _html

import numpy as np


def _cell_color(v, threshold):
    if v is None or (isinstance(v, float) and np.isnan(v)):
        return '#dddddd'
    if v >= 2 * threshold:
        return '#2166ac'   # success (deep blue)
    if v >= threshold:
        return '#92c5de'   # marginal
    return '#d6604d'       # fail (red)


def volumetric_plot_html(data, x_values=None, y_values=None, title=None,
                         threshold=1 / np.e, xlabel='Depth', ylabel='Width'):
    """Render {(x=depth, y=width): value} data as an HTML color grid."""
    xs = sorted({k[0] for k in data}) if x_values is None else list(x_values)
    ys = sorted({k[1] for k in data}) if y_values is None else list(y_values)
    out = ['<div class="vb-plot">']
    if title:
        out.append('<h3>%s</h3>' % _html.escape(str(title)))
    out.append('<table border="0" cellspacing="1" cellpadding="0">')
    for y in reversed(ys):
        cells = []
        for x in xs:
            v = data.get((x, y))
            tip = '%s=%s %s=%s: %s' % (xlabel, x, ylabel, y,
                                       'n/a' if v is None else '%.3f' % v)
            cells.append('<td title="%s" style="background:%s;width:22px;'
                         'height:22px"></td>'
                         % (_html.escape(tip), _cell_color(v, threshold)))
        out.append('<tr><td align="right">%s&nbsp;</td>%s</tr>'
                   % (y, ''.join(cells)))
    out.append('<tr><td></td>%s</tr>' % ''.join(
        '<td align="center">%s</td>' % x for x in xs))
    out.append('</table><p>%s &rarr;</p></div>' % _html.escape(xlabel))
    return '\n'.join(out)


def capability_region_plot_html(vbdataframe, metric='polarization',
                                threshold=1 / np.e, title=None):
    """Capability-region grid of a VBDataFrame's mean `metric`."""
    data = vbdataframe.vb_data(metric=metric, statistic='mean')
    return volumetric_plot_html(data, threshold=threshold,
                                title=title or 'Capability region (%s)' % metric)


def volumetric_boundary_data(data, threshold=0.5):
    """For each depth, the largest width with value >= threshold (the
    capability region's boundary)."""
    xs = sorted({k[0] for k in data})
    out = {}
    for x in xs:
        widths = [y for (xx, y), v in data.items()
                  if xx == x and v is not None and v >= threshold]
        out[x] = max(widths) if widths else 0
    return out
