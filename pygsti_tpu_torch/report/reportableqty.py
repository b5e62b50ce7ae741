"""ReportableQty: a value with an optional error bar (counterpart of
pygsti_tpu/report/reportableqty.py)."""

from __future__ import annotations

import numpy as np


class ReportableQty(object):
    """Value + error bar container used throughout report tables
    (reference: reportableqty.ReportableQty)."""

    def __init__(self, value, errbar=None, non_markovian_ebs=False):
        self._value = value
        self._errbar = errbar
        self.nonMarkovianEBs = non_markovian_ebs

    @property
    def value(self):
        return self._value

    @property
    def errbar(self):
        return self._errbar

    def has_errorbar(self):
        return self._errbar is not None

    def value_and_errorbar(self):
        return self._value, self._errbar

    def __float__(self):
        return float(self._value)

    def __str__(self):
        if self.has_errorbar():
            return "%s +/- %s" % (self._value, self._errbar)
        return str(self._value)

    def __repr__(self):
        return "ReportableQty(%s)" % str(self)

    def __add__(self, x):
        other = x.value if isinstance(x, ReportableQty) else x
        eb = self._errbar
        if isinstance(x, ReportableQty) and x.has_errorbar():
            eb = np.sqrt(np.asarray(eb or 0) ** 2 + np.asarray(x.errbar) ** 2)
        return ReportableQty(self._value + other, eb, self.nonMarkovianEBs)

    def __mul__(self, x):
        assert not isinstance(x, ReportableQty), \
            "Multiplying two ReportableQtys is not supported"
        eb = None if self._errbar is None else self._errbar * abs(x)
        return ReportableQty(self._value * x, eb, self.nonMarkovianEBs)

    def absdiff(self, constant_value, separate_re_im=False):
        return ReportableQty(np.abs(self._value - constant_value),
                             self._errbar, self.nonMarkovianEBs)

    def scale_inplace(self, factor):
        self._value = self._value * factor
        if self._errbar is not None:
            self._errbar = self._errbar * abs(factor)

    @classmethod
    def from_val(cls, value, non_markovian_ebs=False):
        """Build from a value or a (value, errbar) tuple (reference:
        ReportableQty.from_val)."""
        if isinstance(value, ReportableQty):
            return value
        if isinstance(value, tuple) and len(value) == 2:
            return cls(value[0], value[1], non_markovian_ebs)
        return cls(value, None, non_markovian_ebs)
