"""Elementary error-generator labels in their local and global spellings
(counterpart of pygsti_tpu/baseobjs/errorgenlabel.py).

* ``LocalElementaryErrorgenLabel('S', ('XI',))``: basis-element labels are
  full-width Pauli strings over an implicit qubit ordering.
* ``GlobalElementaryErrorgenLabel('S', ('X',), (0,))``: basis-element labels
  cover only the support, named explicitly by state-space labels.
"""

from __future__ import annotations


class ElementaryErrorgenLabel(object):
    """Base class for elementary errorgen labels."""


class LocalElementaryErrorgenLabel(ElementaryErrorgenLabel):
    """Label with full-width basis-element strings."""

    @classmethod
    def cast(cls, obj, sslbls=None, identity_label='I'):
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, GlobalElementaryErrorgenLabel):
            if sslbls is None:
                raise ValueError("sslbls needed to convert a global label to a local one")
            return cls(obj.errorgen_type,
                       obj.padded_basis_element_labels(sslbls, identity_label))
        if isinstance(obj, (tuple, list)):
            return cls(obj[0], tuple(obj[1:]) if not isinstance(obj[1], (tuple, list))
                       else tuple(obj[1]))
        if isinstance(obj, str):
            typ, rest = obj[0], obj[1:].strip('()')
            return cls(typ, tuple(p for p in rest.split(',') if p))
        raise ValueError("Cannot cast %r to %s" % (obj, cls.__name__))

    def __init__(self, errorgen_type, basis_element_labels):
        self.errorgen_type = str(errorgen_type)
        self.basis_element_labels = tuple(basis_element_labels)

    def __hash__(self):
        return hash((self.errorgen_type, self.basis_element_labels))

    def __eq__(self, other):
        return isinstance(other, LocalElementaryErrorgenLabel) \
            and self.errorgen_type == other.errorgen_type \
            and self.basis_element_labels == other.basis_element_labels

    def __str__(self):
        return "%s(%s)" % (self.errorgen_type,
                           ",".join(map(str, self.basis_element_labels)))

    __repr__ = __str__

    def support_indices(self, identity_label='I'):
        """Positions where any basis-element label is not the identity."""
        n = len(self.basis_element_labels[0])
        return tuple(i for i in range(n)
                     if any(bel[i] != identity_label for bel in self.basis_element_labels))


class GlobalElementaryErrorgenLabel(ElementaryErrorgenLabel):
    """Label with support-only basis elements and explicit state-space labels."""

    @classmethod
    def cast(cls, obj, sslbls=None, identity_label='I'):
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, LocalElementaryErrorgenLabel):
            if sslbls is None:
                raise ValueError("sslbls needed to convert a local label to a global one")
            support = obj.support_indices(identity_label) or (0,)
            bels = tuple(''.join(bel[i] for i in support)
                         for bel in obj.basis_element_labels)
            return cls(obj.errorgen_type, bels, tuple(sslbls[i] for i in support))
        if isinstance(obj, (tuple, list)):
            return cls(obj[0], tuple(obj[1]), tuple(obj[2]))
        raise ValueError("Cannot cast %r to %s" % (obj, cls.__name__))

    def __init__(self, errorgen_type, basis_element_labels, sslbls, sort=True):
        self.errorgen_type = str(errorgen_type)
        bels = tuple(basis_element_labels)
        sslbls = tuple(sslbls)
        if sort and len(sslbls) > 1:
            order = sorted(range(len(sslbls)), key=lambda i: str(sslbls[i]))
            sslbls = tuple(sslbls[i] for i in order)
            bels = tuple(''.join(b[i] for i in order) for b in bels)
        self.basis_element_labels = bels
        self.sslbls = sslbls

    def __hash__(self):
        return hash((self.errorgen_type, self.basis_element_labels, self.sslbls))

    def __eq__(self, other):
        return isinstance(other, GlobalElementaryErrorgenLabel) \
            and self.errorgen_type == other.errorgen_type \
            and self.basis_element_labels == other.basis_element_labels \
            and self.sslbls == other.sslbls

    def __str__(self):
        return "%s(%s:%s)" % (self.errorgen_type,
                              ",".join(map(str, self.basis_element_labels)),
                              ",".join(map(str, self.sslbls)))

    __repr__ = __str__

    @property
    def support(self):
        return self.sslbls

    def padded_basis_element_labels(self, all_sslbls, identity_label='I'):
        """Full-width basis-element strings over `all_sslbls`."""
        idx = {s: i for i, s in enumerate(all_sslbls)}
        out = []
        for bel in self.basis_element_labels:
            chars = [identity_label] * len(all_sslbls)
            for ch, s in zip(bel, self.sslbls):
                chars[idx[s]] = ch
            out.append(''.join(chars))
        return tuple(out)
