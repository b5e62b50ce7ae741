"""Circuit-list construction utilities (counterpart of
pygsti_tpu/circuits/circuitconstruction.py), host Python.

``list_random_circuits_onelen`` draws from numpy's ``RandomState(seed)`` in
the JAX package's order, so one seed gives the JAX package's circuits.  A
template of ``create_circuits`` that evaluates to a string is parsed into a
Circuit (the JAX package imports a parser function that does not exist
there, and raises ImportError).
"""

from __future__ import annotations

import itertools

import numpy as np

from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.circuits.gstcircuits import (repeat_and_truncate,  # noqa: F401
                                                   repeat_with_max_length)


def to_circuits(list_of_op_label_tuples, line_labels=None):
    """Circuits of tuples of op labels."""
    return [Circuit(t, line_labels=line_labels) for t in list_of_op_label_tuples]


def repeat(x, num_times, assert_at_least_one_rep=False):
    """`x` repeated `num_times`."""
    if assert_at_least_one_rep:
        assert num_times > 0
    return x * num_times


def repeat_count_with_max_length(x, max_length, assert_at_least_one_rep=False):
    """floor(max_length / len(x)), 0 for an empty x."""
    reps = max_length // len(x) if len(x) > 0 else 0
    if assert_at_least_one_rep:
        assert reps > 0
    return reps


def iter_all_circuits_onelen(op_labels, length):
    """Every circuit of `length` layers over `op_labels`."""
    for combo in itertools.product(op_labels, repeat=length):
        yield Circuit(combo)


def list_all_circuits_onelen(op_labels, length):
    return list(iter_all_circuits_onelen(op_labels, length))


def iter_all_circuits(op_labels, min_length, max_length):
    """Every circuit of min_length to max_length layers, shortest first."""
    for L in range(min_length, max_length + 1):
        yield from iter_all_circuits_onelen(op_labels, L)


def list_all_circuits(op_labels, min_length, max_length):
    return list(iter_all_circuits(op_labels, min_length, max_length))


def list_all_circuits_without_powers_and_cycles(op_labels, max_length):
    """Every circuit up to `max_length` layers that is neither a power of a
    shorter circuit nor a cyclic rotation of one listed before it: the
    usual germ candidates."""
    out, seen = [], set()
    for L in range(1, max_length + 1):
        for combo in itertools.product(op_labels, repeat=L):
            if any(L % d == 0 and combo == combo[:d] * (L // d) for d in range(1, L)):
                continue
            canon = min(combo[i:] + combo[:i] for i in range(L))
            if canon in seen:
                continue
            seen.add(canon)
            out.append(Circuit(combo))
    return out


def list_random_circuits_onelen(op_labels, length, count, seed=None):
    """`count` circuits of `length` layers, each layer drawn uniformly from
    `op_labels` by ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    ops = list(op_labels)
    return [Circuit([ops[rng.randint(len(ops))] for _ in range(length)])
            for _ in range(count)]


def list_partial_circuits(circuit):
    """Every prefix of a circuit as a layer tuple, the empty and the whole
    one included."""
    tup = tuple(circuit.layertup if isinstance(circuit, Circuit) else circuit)
    return [tuple(tup[:i]) for i in range(len(tup) + 1)]


def translate_circuit(circuit, alias_dict):
    """The circuit with each layer found in `alias_dict` replaced by the
    layers it maps to."""
    if alias_dict is None:
        return circuit
    new_layers = []
    for lbl in circuit.layertup:
        if lbl in alias_dict:
            new_layers.extend(alias_dict[lbl])
        else:
            new_layers.append(lbl)
    return Circuit(tuple(new_layers), circuit.line_labels)


def translate_circuits(circuits, alias_dict):
    return [translate_circuit(c, alias_dict) for c in circuits]


def _within(circuit, keep):
    for layer in circuit.layertup:
        for comp in ((layer,) if layer.is_simple else tuple(layer.components)):
            if comp.sslbls is not None and not set(comp.sslbls) <= keep:
                return False
    return True


def filter_circuits(circuits, sslbls_to_keep, new_sslbls=None, drop=False):
    """The circuits whose every gate acts within `sslbls_to_keep`; any
    other becomes None, or is left out with `drop`.  `new_sslbls` is
    accepted for the JAX package's signature."""
    keep = set(sslbls_to_keep)
    out = []
    for c in circuits:
        if _within(c, keep):
            out.append(c)
        elif not drop:
            out.append(None)
    return out


def filter_circuit(circuit, sslbls_to_keep, new_sslbls=None, drop=False):
    """filter_circuits of one circuit: the circuit or None."""
    out = filter_circuits([circuit], sslbls_to_keep, new_sslbls, drop)
    return out[0] if out else None


def create_circuits(*args, **kwargs):
    """Circuits from python-expression templates evaluated in nested loops
    over the list and tuple keyword arguments (the others are constants);
    `order` sets the loop nesting.  A template that raises AssertionError
    for some values skips them.  Example::

        create_circuits('f0+germ*e+f1', f0=fids, f1=fids, germ=germs, e=2)
    """
    lst = []
    loop_order = list(kwargs.pop('order', []))
    loop_lists = {}
    loop_locals = {'True': True, 'False': False, 'str': str, 'int': int, 'float': float}
    for key, val in kwargs.items():
        if type(val) in (list, tuple):
            loop_lists[key] = val
            if key not in loop_order:
                loop_order.append(key)
        else:
            loop_locals[key] = val
    for expr in args:
        if len(expr) == 0:
            lst.append(Circuit(()))
            continue
        keys = [k for k in loop_order if k in expr]
        for vals in itertools.product(*[loop_lists[k] for k in keys]):
            scope = dict(zip(keys, vals))
            scope.update(loop_locals)
            try:
                result = eval(expr, {"__builtins__": {}}, scope)
            except AssertionError:
                continue
            if isinstance(result, (Circuit, str)):
                lst.append(result if isinstance(result, Circuit) else Circuit(result))
            elif isinstance(result, (list, tuple)):
                lst.append(Circuit(result))
    return lst


def create_lgst_circuits(prep_fiducials, meas_fiducials, op_label_src):
    """The circuits LGST needs, in the JAX package's order: the prep then
    meas fiducials, the fiducial pairs, then the prep + gate + meas
    sandwiches, without repeats.  `op_label_src` is a model or a list of
    operation labels."""
    op_labels = list(op_label_src.operations.keys()) \
        if hasattr(op_label_src, 'operations') else list(op_label_src)
    singles = [Circuit((gl,), prep_fiducials[0].line_labels) for gl in op_labels]
    lgst_list = list(prep_fiducials) + list(meas_fiducials)
    seen = set(lgst_list)

    def add(c):
        if c not in seen:
            seen.add(c)
            lgst_list.append(c)

    for e in meas_fiducials:
        for r in prep_fiducials:
            add(r + e)
    for g in singles:
        for e in meas_fiducials:
            for r in prep_fiducials:
                add(r + g + e)
    return lgst_list


def list_circuits_lgst_can_estimate(dataset, prep_fiducials, meas_fiducials):
    """The circuits c of `dataset`, read as prep + c + meas, whose every
    fiducial sandwich the dataset holds: those whose process matrices LGST
    can estimate."""
    estimatable, seen = [], set()
    ds_circuits = set(dataset.keys())
    for c in dataset.keys():
        for r in prep_fiducials:
            for e in meas_fiducials:
                rl, el = len(r.layertup), len(e.layertup)
                if rl + el > len(c.layertup):
                    continue
                if tuple(c.layertup[:rl]) != tuple(r.layertup):
                    continue
                if el > 0 and tuple(c.layertup[-el:]) != tuple(e.layertup):
                    continue
                mid = Circuit(c.layertup[rl:len(c.layertup) - el], c.line_labels)
                if mid in seen:
                    continue
                if all((r2 + mid + e2) in ds_circuits
                       for r2 in prep_fiducials for e2 in meas_fiducials):
                    seen.add(mid)
                    estimatable.append(mid)
    return estimatable


def manipulate_circuit(circuit, rules, line_labels="auto"):
    """The circuit rewritten by (find, replace) layer-tuple rules, left to
    right, no layer rewritten twice."""
    if rules is None:
        return circuit
    layers = tuple(circuit.layertup)
    out = []
    i = 0
    while i < len(layers):
        for find, replace in rules:
            n = len(find)
            if tuple(layers[i:i + n]) == tuple(find):
                out.extend(replace)
                i += n
                break
        else:
            out.append(layers[i])
            i += 1
    return Circuit(tuple(out), circuit.line_labels if line_labels == "auto" else line_labels)


def manipulate_circuits(circuits, rules, line_labels="auto"):
    return [manipulate_circuit(c, rules, line_labels) for c in circuits]
