"""Functions of a model whose confidence-region error bars propagate
linearly (counterpart of pygsti_tpu/report/modelfunction.py).

A ModelFunction names the members it reads (``dependencies``); the
confidence region's ``compute_uncertainty`` then differences only those
members' parameters: a function that reads ``operations[lbl]`` alone does
not move when another member's parameter does, so its gradient there is 0
and the error bar the same, bit for bit, as with every parameter
differenced.
"""

from __future__ import annotations

import numpy as np


class ModelFunction(object):
    """Base: evaluate(model) -> value; subclasses override evaluate, and
    evaluate_nearby where a linearization about the base model is cheaper.

    `dependencies` is a list of ('gate' | 'prep' | 'povm' | 'effect' |
    'instrument', label) pairs, 'spam' (every prep and POVM) or 'all'."""

    def __init__(self, model, dependencies=('all',)):
        self.base_model = model
        self.dependencies_ = dependencies

    def evaluate(self, model):
        raise NotImplementedError()

    def evaluate_nearby(self, nearby_model):
        """The value at a model near ``base_model``; by default a full
        evaluation."""
        return self.evaluate(nearby_model)

    def dependencies(self):
        return self.dependencies_

    def parameter_indices(self, model):
        """The indices of `model`'s parameters that this function reads,
        or None for all of them (a dependency on 'all', or a model whose
        parameters are not its members', as under a FOGI interposer)."""
        if getattr(model, 'param_interposer', None) is not None:
            return None
        model.to_vector()    # sets each member's gpindices
        containers = {'gate': model.operations, 'prep': model.preps, 'povm': model.povms,
                      'instrument': getattr(model, 'instruments', {})}
        idx = np.arange(model.num_params)
        out = []
        for dep in self.dependencies():
            if dep == 'all':
                return None
            if dep == 'spam':
                members = list(model.preps.values()) + list(model.povms.values())
            else:
                typ, lbl = dep
                if typ == 'effect':     # an effect's parameters are its POVM's
                    typ, lbl = 'povm', str(lbl).split(':')[0]
                members = [containers[typ][lbl]]
            out.extend(idx[m.gpindices] for m in members)
        return np.unique(np.concatenate(out)) if out else np.empty(0, dtype=int)


def modelfn_factory(fn):
    """Wrap a plain function f(model, *args) into a ModelFunction class
    that depends on every member."""
    class _WrappedModelFunction(ModelFunction):
        def __init__(self, model, *args, **kwargs):
            super().__init__(model)
            self.args = args
            self.kwargs = kwargs

        def evaluate(self, model):
            return fn(model, *self.args, **self.kwargs)

    _WrappedModelFunction.__name__ = fn.__name__ + "_modelfn"
    return _WrappedModelFunction


def evaluate_with_error_bars(model_fn, crf_view, eps=1e-7):
    """(value, error bar) of a ModelFunction under a confidence-region view
    (linear propagation through the projected inverse Hessian, over the
    parameters the function depends on)."""
    val = model_fn.evaluate(model_fn.base_model)
    eb = crf_view.compute_uncertainty(model_fn, model_fn.base_model, eps=eps)
    return val, eb


# ---------------------------------------------------------------------------
# Factories wrapping plain metric functions into ModelFunction classes, keyed
# by the members they read.
# ---------------------------------------------------------------------------

def _named(fn, cls):
    cls.__name__ = fn.__name__ + "_class"
    return cls


def spamfn_factory(fn):
    """Class evaluating fn(preps, povms, ...) on a model's SPAM members."""
    class _F(ModelFunction):
        def __init__(self, model, *args, **kwargs):
            self.args, self.kwargs = args, kwargs
            super().__init__(model, ["spam"])

        def evaluate(self, model):
            return fn(list(model.preps.values()),
                      list(model.povms.values()), *self.args, **self.kwargs)
    return _named(fn, _F)


def opfn_factory(fn):
    """Class evaluating fn(gate_matrix, basis, ...) on one operation."""
    class _F(ModelFunction):
        def __init__(self, model, gl, *args, **kwargs):
            self.gl, self.args, self.kwargs = gl, args, kwargs
            super().__init__(model, [("gate", gl)])

        def evaluate(self, model):
            return fn(model.operations[self.gl].dense(), model.basis, *self.args,
                      **self.kwargs)
    return _named(fn, _F)


def opsfn_factory(fn):
    """Class evaluating fn(op1, op2, basis, ...) where op2 comes from a
    second (target) model."""
    class _F(ModelFunction):
        def __init__(self, model1, model2, gl, *args, **kwargs):
            self.other_model, self.gl = model2, gl
            self.args, self.kwargs = args, kwargs
            super().__init__(model1, [("gate", gl)])

        def evaluate(self, model):
            return fn(model.operations[self.gl].dense(),
                      self.other_model.operations[self.gl].dense(),
                      model.basis, *self.args, **self.kwargs)
    return _named(fn, _F)


def instrumentfn_factory(fn):
    """Class evaluating fn(instrument1, instrument2, basis, ...)."""
    class _F(ModelFunction):
        def __init__(self, model1, model2, instrument_lbl, *args, **kwargs):
            self.other_model, self.il = model2, instrument_lbl
            self.args, self.kwargs = args, kwargs
            super().__init__(model1, [("instrument", instrument_lbl)])

        def evaluate(self, model):
            return fn(model.instruments[self.il],
                      self.other_model.instruments[self.il],
                      model.basis, *self.args, **self.kwargs)
    return _named(fn, _F)


def vecfn_factory(fn):
    """Class evaluating fn(vec, basis, ...) on one SPAM vector; `typ` is
    'prep' or 'effect' (an effect label 'povm:outcome', or a POVM label for
    its whole effect stack)."""
    class _F(ModelFunction):
        def __init__(self, model, lbl, typ, *args, **kwargs):
            self.lbl, self.typ = lbl, typ
            self.args, self.kwargs = args, kwargs
            assert typ in ('prep', 'effect'), "typ must be 'prep' or 'effect'"
            super().__init__(model, [(typ, lbl)])

        def _get_vec(self, model):
            if self.typ == 'prep':
                return model.preps[self.lbl].dense()
            povm_lbl, elbl = str(self.lbl).split(':') \
                if ':' in str(self.lbl) else (self.lbl, None)
            povm = model.povms[povm_lbl]
            mx = povm.dense()
            if elbl is not None:
                return mx[povm.outcome_labels.index(elbl)]
            return mx

        def evaluate(self, model):
            return fn(self._get_vec(model), model.basis, *self.args, **self.kwargs)
    return _named(fn, _F)


def vecsfn_factory(fn):
    """Class evaluating fn(vec1, vec2, basis, ...) comparing a SPAM vector
    with a second model's."""
    class _F(ModelFunction):
        def __init__(self, model1, model2, lbl, typ, *args, **kwargs):
            self.other_model, self.lbl, self.typ = model2, lbl, typ
            self.args, self.kwargs = args, kwargs
            self._single = vecfn_factory(lambda v, b: v)
            super().__init__(model1, [(typ, lbl)])

        def evaluate(self, model):
            v1 = self._single(model, self.lbl, self.typ).evaluate(model)
            v2 = self._single(self.other_model, self.lbl,
                              self.typ).evaluate(self.other_model)
            return fn(v1, v2, model.basis, *self.args, **self.kwargs)
    return _named(fn, _F)


def povmfn_factory(fn):
    """Class evaluating fn(model, ...) that reads only the model's POVMs."""
    class _F(ModelFunction):
        def __init__(self, model, *args, **kwargs):
            self.args, self.kwargs = args, kwargs
            dependencies = [("povm", lbl) for lbl in model.povms]
            super().__init__(model, dependencies)

        def evaluate(self, model):
            return fn(model, *self.args, **self.kwargs)
    return _named(fn, _F)
