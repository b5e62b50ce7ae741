"""Structured noise specifications for model construction (counterpart of
pygsti_tpu/models/modelnoise.py).

The construction functions (`create_crosstalk_free_model`,
`create_cloud_crosstalk_model`) take plain dicts (depolarization_strengths,
stochastic_error_probs, lindblad_error_coeffs); these classes are the
object spellings of the same specifications and convert to those dicts.
"""


from __future__ import annotations

import collections


class OpNoise(object):
    """Base class for noise on a single operation."""


class DepolarizationNoise(OpNoise):
    """Depolarization with the given strength."""

    def __init__(self, depolarization_rate, parameterization='depolarize'):
        self.depolarization_rate = float(depolarization_rate)
        self.parameterization = parameterization


class StochasticNoise(OpNoise):
    """Pauli stochastic noise with per-Pauli error rates."""

    def __init__(self, error_probs, parameterization='stochastic'):
        self.error_probs = tuple(error_probs)
        self.parameterization = parameterization


class LindbladNoise(OpNoise):
    """Lindblad-coefficient noise {(typ, basis_lbls...): rate}."""

    def __init__(self, error_coeffs, parameterization='auto'):
        self.error_coeffs = dict(error_coeffs)
        self.parameterization = parameterization

    @classmethod
    def from_basis_coefficients(cls, parameterization, lindblad_basis,
                                state_space, errgen_to_set=None):
        return cls(errgen_to_set or {}, parameterization)


class ModelNoise(object):
    """Base marker class."""


class OpModelNoise(ModelNoise):
    """Noise assigned per operation."""

    @classmethod
    def cast(cls, obj):
        if obj is None or isinstance(obj, OpModelNoise):
            return obj
        if isinstance(obj, dict):
            return OpModelPerOpNoise(obj)
        raise ValueError("Cannot cast %r to OpModelNoise" % type(obj))


class OpModelPerOpNoise(OpModelNoise):
    """{op_name_or_label: OpNoise-or-dict}."""

    def __init__(self, per_op_noise):
        self.per_op_noise = collections.OrderedDict(per_op_noise)

    def to_construction_dicts(self):
        """(depolarization_strengths, stochastic_error_probs,
        lindblad_error_coeffs) dicts as consumed by the construction API."""
        depol, sto, lind = {}, {}, {}
        for key, noise in self.per_op_noise.items():
            if isinstance(noise, DepolarizationNoise):
                depol[key] = noise.depolarization_rate
            elif isinstance(noise, StochasticNoise):
                sto[key] = noise.error_probs
            elif isinstance(noise, LindbladNoise):
                lind[key] = noise.error_coeffs
            elif isinstance(noise, dict):
                lind[key] = dict(noise)
            else:
                raise ValueError("Unknown noise spec for %r: %r"
                                 % (key, type(noise)))
        return depol, sto, lind


class ComposedOpModelNoise(OpModelNoise):
    """Composition of several OpModelNoise objects."""

    def __init__(self, opmodelnoises):
        self.opmodelnoises = [OpModelNoise.cast(n) for n in opmodelnoises]

    def to_construction_dicts(self):
        depol, sto, lind = {}, {}, {}
        for n in self.opmodelnoises:
            d, s, l = n.to_construction_dicts()
            depol.update(d)
            sto.update(s)
            for k, v in l.items():
                lind.setdefault(k, {}).update(v)
        return depol, sto, lind
