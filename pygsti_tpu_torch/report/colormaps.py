"""Colormaps for report plots (counterpart of pygsti_tpu/report/colormaps.py).

Value -> RGB color maps used by the color box / matrix plots:

* :class:`LinlogColormap` -- the signature GST map: linear GRAYSCALE below a
  chi^2-percentile transition point, logarithmic COLOR (red by default)
  above it, so statistically-expected deviations stay gray and significant
  model violation saturates red (reference colormaps.py:312-543).
* :class:`DivergingColormap` -- blue -> white -> red about a midpoint
  (reference :545).
* :class:`SequentialColormap` -- white->black/blue/red ramps (reference
  :625).
* :class:`PiecewiseLinearColormap` -- arbitrary anchor points (:698).

Implementation is plain vectorized numpy (no plotly / matplotlib / masked
arrays); colors are exposed as ``rgb(r,g,b)`` strings and hex for HTML.
"""

from __future__ import annotations

import numpy as np


def _vnorm(x, vmin, vmax):
    """Linear [vmin, vmax] -> [0, 1] with clipping (reference
    colormaps._vnorm:20)."""
    x = np.asarray(x, float)
    if abs(vmin - vmax) < (1e-8 + 1e-5 * vmax):
        return np.zeros_like(x)
    return np.clip((x - vmin) / (vmax - vmin), 0.0, 1.0)


def to_rgb_array(color_str):
    """'#00FF88' or 'rgb(0,255,136)' -> float array [r, g, b] in 0..255."""
    s = color_str.strip()
    if s.startswith('#') and len(s) >= 7:
        return np.array([float(int(s[i:i + 2], 16)) for i in (1, 3, 5)])
    if s.startswith('rgb(') and s.endswith(')'):
        return np.array([float(x) for x in s[4:-1].split(',')])
    if s.startswith('rgba(') and s.endswith(')'):
        return np.array([float(x) for x in s[5:-1].split(',')[:3]])
    raise ValueError("Cannot convert color_str = %r" % (color_str,))


class Colormap(object):
    """A list of (anchor, (r, g, b)) color points over normalized [0, 1]
    plus a normalization (reference: colormaps.Colormap:110).  `rgb_colors`
    anchors are floats in [0, 1]; r/g/b are floats in [0, 1]."""

    def __init__(self, rgb_colors, hmin, hmax, invalid_color=None):
        self.rgb_colors = rgb_colors
        self.hmin = hmin
        self.hmax = hmax
        self.invalid_color = invalid_color

    # -- normalization ------------------------------------------------------
    def normalize(self, value):
        """Pre-interpolation normalization (identity in the base class; the
        heatmap's [hmin, hmax] window does the linear mapping)."""
        return value

    def normalize_interpolate(self, value):
        """Full value -> [0, 1] normalization for interpolate_color."""
        raise NotImplementedError("Derived classes define this")

    # -- colors -------------------------------------------------------------
    def _interp_rgb(self, z):
        """Normalized z in [0,1] -> float [r, g, b] in 0..1."""
        pts = self.rgb_colors
        if self.invalid_color is not None and (z < 0.0 or z > 1.0
                                               or not np.isfinite(z)):
            return np.asarray(self.invalid_color, float)
        z = min(max(float(z), 0.0), 1.0) if np.isfinite(z) else 0.0
        for i in range(1, len(pts)):
            if z < pts[i][0]:
                z1, c1 = pts[i - 1]
                z2, c2 = pts[i]
                a = (z - z1) / (z2 - z1) if z2 > z1 else 0.0
                return np.asarray(c1, float) \
                    + a * (np.asarray(c2, float) - np.asarray(c1, float))
        return np.asarray(pts[-1][1], float)

    def interpolate_color(self, value):
        """Un-normalized value -> 'rgb(R,G,B)' string (reference
        Colormap.interpolate_color:256)."""
        rgb = self._interp_rgb(self.normalize_interpolate(value))
        return 'rgb(%d,%d,%d)' % tuple(int(round(255 * c)) for c in rgb)

    def interpolate_hex(self, value):
        """Un-normalized value -> '#rrggbb' (HTML cell colors)."""
        rgb = self._interp_rgb(self.normalize_interpolate(value))
        return '#%02x%02x%02x' % tuple(
            min(255, max(0, int(round(255 * c)))) for c in rgb)

    def _brightness(self, r, g, b):
        # perceived brightness (http://alienryderflex.com/hsp.html)
        return np.sqrt(0.299 * r ** 2 + 0.587 * g ** 2 + 0.114 * b ** 2)

    def besttxtcolor(self, value):
        """'black' or 'white', whichever reads better on this value's
        color (reference Colormap.besttxtcolor:215)."""
        z = _vnorm(self.normalize(value), self.hmin, self.hmax)
        r, g, b = self._interp_rgb(float(z))
        return "black" if 0.5 <= self._brightness(r, g, b) else "white"

    def create_plotly_colorscale(self):
        """[[z, 'rgb(R,G,B)'], ...] anchor list (API parity; reference
        :242)."""
        return [[z, 'rgb(%d,%d,%d)' % (round(r * 255), round(g * 255),
                                       round(b * 255))]
                for z, (r, g, b) in self.rgb_colors]


class LinlogColormap(Colormap):
    """Linear grayscale below a chi^2-percentile transition, log color
    above (reference: colormaps.LinlogColormap:312).

    trans = ceil(chi2_[dof].ppf(1 - pcntle/num_boxes)) -- the value the
    WORST of `num_boxes` chi^2_[dof] samples exceeds with probability
    `pcntle` (max-of-N order statistics via (1-x)^{1/N} ~ 1 - x/N).
    """

    def __init__(self, vmin, vmax, num_boxes, pcntle, dof_per_box,
                 color="red"):
        from scipy.stats import chi2 as _chi2
        self.N = num_boxes
        self.percentile = pcntle
        self.dof = dof_per_box
        N = max(self.N, 1)
        self.trans = np.ceil(_chi2.ppf(1 - self.percentile / N,
                                       self.dof))
        self.vmin = vmin
        self.vmax = max(vmax, self.trans)

        gray = (0.4, 0.4, 0.4)
        colors = {"red": ((0.77, 0.143, 0.146), (1.0, 0, 0)),
                  "blue": ((0, 0, 0.7), (0, 0, 1.0)),
                  "green": ((0.0, 0.483, 0.0), (0, 1.0, 0)),
                  "cyan": ((0.0, 0.46, 0.46), (0.0, 1.0, 1.0)),
                  "yellow": ((0.415, 0.415, 0.0), (1.0, 1.0, 0)),
                  "purple": ((0.72, 0.0, 0.72), (1.0, 0, 1.0))}
        if color not in colors:
            raise ValueError("Unknown color: %s" % color)
        c, mx = colors[color]
        super().__init__([[0.0, (1., 1., 1.)], [0.499999999, gray],
                          [0.5, c], [1.0, mx]],
                         0, 1, invalid_color=(0.8, 0.8, 1.0))

    @classmethod
    def set_manual_transition_point(cls, vmin, vmax, trans, color="red"):
        cmap = cls(vmin, vmax, num_boxes=1, pcntle=0.5, dof_per_box=1,
                   color=color)
        cmap.trans = trans
        cmap.vmax = max(cmap.vmax, trans)
        return cmap

    def normalize(self, value):
        """value -> [0, 1]: linear [0, trans) -> [off/(2(1+off)), 0.5),
        log [trans, vmax] -> [0.5, 1.0] (reference LinlogColormap
        .normalize:449)."""
        value = np.asarray(value, float)
        lin = _vnorm(value, self.vmin, self.vmax)
        norm_trans = float(_vnorm(self.trans, self.vmin, self.vmax))
        with np.errstate(divide='ignore', invalid='ignore'):
            log10_nt = np.log10(norm_trans) if norm_trans != 1.0 else 1.0
            off = 0.1
            linear_part = (lin / norm_trans + off) / (1.0 + off) * 0.5
            log_part = (log10_nt - np.log10(lin)) / (2 * log10_nt) + 0.5
            out = np.where(norm_trans > lin, linear_part, log_part)
        return out.item() if out.shape == () else out

    def normalize_interpolate(self, value):
        return self.normalize(value)


class DivergingColormap(Colormap):
    """Blue -> white -> red about a midpoint (reference :545)."""

    def __init__(self, vmin, vmax, midpoint=0.0, color="RdBu"):
        self.midpoint = midpoint
        assert midpoint == 0.0, "midpoint doesn't work yet!"
        if color != "RdBu":
            raise ValueError("Unknown color: %s" % color)
        super().__init__([[0.0, (0.0, 0.0, 1.0)], [0.5, (1.0, 1.0, 1.0)],
                          [1.0, (1.0, 0.0, 0.0)]], vmin, vmax)

    def normalize_interpolate(self, value):
        return _vnorm(value, self.hmin, self.hmax)


class SequentialColormap(Colormap):
    """Monotone white<->black/blue/red ramps (reference :625)."""

    def __init__(self, vmin, vmax, color="whiteToBlack"):
        ramps = {"whiteToBlack": [[0, (1., 1., 1.)], [1.0, (0., 0., 0.)]],
                 "blackToWhite": [[0, (0., 0., 0.)], [1.0, (1., 1., 1.)]],
                 "whiteToBlue": [[0, (1., 1., 1.)], [1.0, (0., 0., 1.)]],
                 "whiteToRed": [[0, (1., 1., 1.)], [1.0, (1., 0., 0.)]]}
        if color not in ramps:
            raise ValueError("Unknown color: %s" % color)
        super().__init__(ramps[color], vmin, vmax)

    def normalize_interpolate(self, value):
        return _vnorm(value, self.hmin, self.hmax)


class PiecewiseLinearColormap(Colormap):
    """Arbitrary (value, rgb) anchor points (reference :698)."""

    def __init__(self, rgb_colors):
        hmin = min(v for v, _ in rgb_colors)
        hmax = max(v for v, _ in rgb_colors)

        def norm(x):
            return (x - hmin) / (hmax - hmin) if hmax > hmin else 0.0

        super().__init__([[norm(v), rgb] for v, rgb in rgb_colors],
                         hmin, hmax)

    def normalize_interpolate(self, value):
        return _vnorm(value, self.hmin, self.hmax)
