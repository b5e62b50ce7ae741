"""Report plots: per-circuit model-violation color box plots, scatter and
histogram summaries as self-contained HTML and SVG (counterpart of
pygsti_tpu/report/workspaceplots.py; no plotly).

The per-circuit values come from one forward scan of every circuit on the
card (the port's simulator, on the report's device) and the port's raw
objective terms.  Cells are colored by LinlogColormap: linear grayscale
below the chi^2-percentile transition point (expected statistical
fluctuation), logarithmic red above it (significant model violation).
"""

from __future__ import annotations

import html as _html

import numpy as np
import torch

from pygsti_tpu_torch import DTYPE
from pygsti_tpu_torch.report.colormaps import LinlogColormap


def per_circuit_2dlogl(model, dataset, circuits, objective='logl', device="cuda"):
    """Per-circuit 2*Delta(logL) (or chi2) contributions {circuit: value},
    from one bulk evaluation of the probabilities on `device`."""
    from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
    from pygsti_tpu_torch.objectivefns.objectivefns import (RawChi2Function,
                                                            RawPoissonPicDeltaLogLFunction)
    circuits = list(circuits)
    sim = SimpleForwardSimulator(model, device)
    layout = sim.create_layout(circuits, dataset)
    counts, totals = layout.counts_arrays(dataset)
    with np.errstate(invalid='ignore', divide='ignore'):
        freqs = np.where(totals > 0, counts / np.maximum(totals, 1), 0.0)
    raw = RawPoissonPicDeltaLogLFunction() if objective == 'logl' else RawChi2Function()
    with torch.no_grad():
        v = torch.as_tensor(model.to_vector(), dtype=DTYPE, device=sim.device)
        p = sim.probs_fn(layout)(v)
        data = [torch.as_tensor(a, dtype=DTYPE, device=sim.device)
                for a in (counts, totals, freqs)]
        terms = raw.terms(p, *data).cpu().numpy()
    scale = 2.0 if objective == 'logl' else 1.0
    return {c: scale * float(np.sum(terms[layout.element_slices[i]]))
            for i, c in enumerate(circuits)}


def _linlog_colormap(values_by_circuit, model, linlog_percentile=0.05):
    """The LinlogColormap of a box plot: one box per circuit, (outcomes of
    the model's largest POVM - 1) degrees of freedom per box."""
    vals = np.array([v for v in values_by_circuit.values() if np.isfinite(v)])
    n_boxes = max(len(vals), 1)
    n_out = max(povm.num_outcomes for povm in model.povms.values())
    dof = max(n_out - 1, 1)
    vmax = float(np.max(vals)) if len(vals) else 1.0
    return LinlogColormap(0, vmax, n_boxes, linlog_percentile, dof)


def _grid_shape(plaq):
    rows = plaq.num_rows if plaq.num_rows is not None \
        else max(i for i, _ in plaq.elements) + 1
    cols = plaq.num_cols if plaq.num_cols is not None \
        else max(j for _, j in plaq.elements) + 1
    return rows, cols


def color_boxplot_html(circuit_struct, values_by_circuit, title='', colormap=None, model=None):
    """Nested color box plot over the (L, germ) plaquette grid as an HTML
    table of colored sub-grids.  Cells are colored by `colormap` (default
    the linlog map of the values)."""
    plaqs = circuit_struct.plaquettes
    xs = [x for x in circuit_struct.xs if any(len(plaqs.get((x, y), ())) for y in circuit_struct.ys)]
    ys = [y for y in circuit_struct.ys if any(len(plaqs.get((x, y), ())) for x in circuit_struct.xs)]
    cmap = colormap or _linlog_colormap(values_by_circuit, model)

    rows_html = []
    header = '<tr><th></th>' + ''.join(
        '<th>L=%s</th>' % _html.escape(str(x)) for x in xs) + '</tr>'
    for y in ys:
        cells = []
        for x in xs:
            plaq = plaqs.get((x, y))
            if plaq is None or len(plaq) == 0:
                cells.append('<td class="empty"></td>')
                continue
            nr, nc = _grid_shape(plaq)
            grid = [['' for _ in range(nc)] for _ in range(nr)]
            for (i, j), c in plaq.elements.items():
                v = values_by_circuit.get(c, np.nan)
                color = cmap.interpolate_hex(v) if np.isfinite(v) else '#ccccff'
                tip = _html.escape('%s : %.3g' % (c.str, v))
                grid[i][j] = ('<div class="bx" style="background:%s" '
                              'title="%s"></div>' % (color, tip))
            inner = ''.join('<div class="bxrow">%s</div>' % ''.join(r) for r in grid)
            cells.append('<td><div class="plaq">%s</div></td>' % inner)
        label = getattr(y, 'str', str(y))
        rows_html.append('<tr><th class="germ">%s</th>%s</tr>'
                         % (_html.escape(label), ''.join(cells)))

    style = ('<style>.plaq{display:inline-block;border:1px solid #999;}'
             '.bxrow{display:flex;}'
             '.bx{width:10px;height:10px;border:0.5px solid #eee;}'
             'td.empty{background:#f8f8f8;}'
             'th.germ{font-family:monospace;text-align:right;'
             'font-size:11px;padding-right:4px;}</style>')
    legend = ('<p class="meta">linear gray below %.3g '
              '(expected fluctuation), log red above</p>' % getattr(cmap, 'trans', np.nan))
    return ('%s<h4>%s</h4>%s<table class="boxplot">%s%s</table>'
            % (style, _html.escape(title), legend, header, ''.join(rows_html)))


def _svg_frame(inner, width, height, xlabel, ylabel, title):
    return ('<figure class="rplot"><figcaption>%s</figcaption>'
            '<svg width="%d" height="%d" viewBox="0 0 %d %d" '
            'style="background:#fff;border:1px solid #ccc">%s'
            '<text x="%d" y="%d" font-size="11" text-anchor="middle">%s'
            '</text>'
            '<text x="12" y="%d" font-size="11" text-anchor="middle" '
            'transform="rotate(-90 12 %d)">%s</text></svg></figure>'
            % (_html.escape(title), width, height, width, height, inner,
               width // 2, height - 4, _html.escape(xlabel),
               height // 2, height // 2, _html.escape(ylabel)))


def _axes(pad_l, pad_t, w, h, width, pad_r):
    return ('<line x1="%d" y1="%d" x2="%d" y2="%d" stroke="#333"/>'
            '<line x1="%d" y1="%d" x2="%d" y2="%d" stroke="#333"/>'
            % (pad_l, pad_t + h, width - pad_r, pad_t + h, pad_l, pad_t, pad_l, pad_t + h))


def scatter_plot_html(values_by_circuit, title='', colormap=None, model=None, width=640,
                      height=320):
    """Scatter of per-circuit model-violation values against circuit depth,
    the points colored by the linlog colormap."""
    circuits = list(values_by_circuit.keys())
    vals = np.array([values_by_circuit[c] for c in circuits], float)
    depths = np.array([c.depth for c in circuits], float)
    ok = np.isfinite(vals)
    cmap = colormap or _linlog_colormap(values_by_circuit, model)
    pad_l, pad_r, pad_t, pad_b = 42, 10, 10, 30
    w, h = width - pad_l - pad_r, height - pad_t - pad_b
    xmax = max(depths[ok].max() if ok.any() else 1.0, 1.0)
    ymax = max(vals[ok].max() if ok.any() else 1.0, 1e-6)
    pts = []
    for d, v in zip(depths[ok], vals[ok]):
        x = pad_l + w * d / xmax
        y = pad_t + h * (1 - max(v, 0.0) / ymax)
        pts.append('<circle cx="%.1f" cy="%.1f" r="2.2" fill="%s" '
                   'fill-opacity="0.75"><title>depth %d : %.3g</title>'
                   '</circle>' % (x, y, cmap.interpolate_hex(v), d, v))
    trans = getattr(cmap, 'trans', None)       # the statistical-significance threshold
    if trans is not None and trans <= ymax:
        ty = pad_t + h * (1 - trans / ymax)
        pts.append('<line x1="%d" y1="%.1f" x2="%d" y2="%.1f" '
                   'stroke="#999" stroke-dasharray="4,3"/>' % (pad_l, ty, width - pad_r, ty))
    return _svg_frame(_axes(pad_l, pad_t, w, h, width, pad_r) + ''.join(pts), width, height,
                      'circuit depth', '2Δlogℓ', title)


def histogram_plot_html(values_by_circuit, title='', colormap=None, model=None, n_bins=30,
                        width=640, height=320):
    """Log-count histogram of per-circuit model-violation values, the bars
    colored by the linlog colormap."""
    vals = np.array([v for v in values_by_circuit.values() if np.isfinite(v)], float)
    cmap = colormap or _linlog_colormap(values_by_circuit, model)
    if len(vals) == 0:
        return _svg_frame('', width, height, 'value', 'count', title)
    vmax = max(float(vals.max()), 1e-6)
    edges = np.linspace(0.0, vmax * 1.0001, n_bins + 1)
    counts, _ = np.histogram(np.clip(vals, 0, None), bins=edges)
    pad_l, pad_r, pad_t, pad_b = 42, 10, 10, 30
    w, h = width - pad_l - pad_r, height - pad_t - pad_b
    log_max = np.log10(max(counts.max(), 1)) or 1.0
    bars = []
    bw = w / n_bins
    for i, cnt in enumerate(counts):
        if cnt == 0:
            continue
        bh = h * (np.log10(cnt + 1) / np.log10(10 ** log_max + 1))
        mid = 0.5 * (edges[i] + edges[i + 1])
        bars.append('<rect x="%.1f" y="%.1f" width="%.1f" height="%.1f" '
                    'fill="%s" stroke="#666" stroke-width="0.5">'
                    '<title>[%.3g, %.3g) : %d circuits</title></rect>'
                    % (pad_l + i * bw, pad_t + h - bh, bw, bh, cmap.interpolate_hex(mid),
                       edges[i], edges[i + 1], cnt))
    return _svg_frame(_axes(pad_l, pad_t, w, h, width, pad_r) + ''.join(bars), width, height,
                      'per-circuit value', 'count (log)', title)


def model_violation_boxplot_html(model, dataset, circuit_struct, objective='logl',
                                 include_summaries=True, device="cuda", values=None):
    """The per-circuit model-violation section: color box plot, then the
    scatter and histogram summaries.  `values` ({circuit: value}, as
    per_circuit_2dlogl returns) are computed on `device` when not given."""
    vals = values if values is not None else \
        per_circuit_2dlogl(model, dataset, list(circuit_struct), objective, device)
    name = '2&Delta;log&#8467;' if objective == 'logl' else '&chi;&sup2;'
    cmap = _linlog_colormap(vals, model)
    parts = [color_boxplot_html(circuit_struct, vals, colormap=cmap, model=model,
                                title='Per-circuit %s contributions' % name)]
    if include_summaries:
        parts.append(scatter_plot_html(vals, colormap=cmap, model=model,
                                       title='Per-circuit model violation vs circuit depth'))
        parts.append(histogram_plot_html(vals, colormap=cmap, model=model,
                                         title='Distribution of per-circuit model violation'))
    return '\n'.join(parts)
