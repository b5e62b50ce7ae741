"""Taylor-term objects (counterpart of pygsti_tpu/modelmembers/term.py).

The term simulator (forwardsims/termforwardsim.py) represents its terms as
dense generator stacks and coefficient tensors; this module keeps the
RankOneTerm name for code that constructs terms directly.  Host Python.
"""

from __future__ import annotations


class RankOneTerm(object):
    """A rank-one term: polynomial coefficient x pre/post operation words
    (reference: term.RankOneTerm)."""

    def __init__(self, coeff, pre_ops=(), post_ops=(), magnitude=1.0):
        self.coeff = coeff
        self.pre_ops = tuple(pre_ops)
        self.post_ops = tuple(post_ops)
        self.magnitude = magnitude

    def scalar_mult(self, x):
        out = RankOneTerm(self.coeff, self.pre_ops, self.post_ops,
                          self.magnitude * abs(x))
        try:
            out.coeff = self.coeff * x
        except TypeError:
            pass
        return out

    def __repr__(self):
        return "RankOneTerm(%r, pre=%r, post=%r)" % (self.coeff,
                                                     self.pre_ops,
                                                     self.post_ops)
