"""The port's circuits/circuitconstruction.py against the JAX package's:
every function on the same inputs and seeds gives the same circuits (by
their strings), as one parametrised test; and the one decision the port
takes where the JAX package raises (a template that evaluates to a
string)."""

from types import SimpleNamespace

import pytest

from pygsti_tpu.baseobjs.label import Label as JLabel
from pygsti_tpu.circuits import circuitconstruction as jcc
from pygsti_tpu.circuits.circuit import Circuit as JCircuit
from pygsti_tpu.data.dataset import DataSet as JDataSet
import pygsti_tpu.modelpacks.smq1Q_XYI as jmp

from pygsti_tpu_torch.baseobjs.label import Label as TLabel
from pygsti_tpu_torch.circuits import circuitconstruction as tcc
from pygsti_tpu_torch.circuits.circuit import Circuit as TCircuit
from pygsti_tpu_torch.data.dataset import DataSet as TDataSet
import pygsti_tpu_torch.modelpacks.smq1Q_XYI as tmp

PKGS = {'jax': SimpleNamespace(cc=jcc, Circuit=JCircuit, Label=JLabel, DataSet=JDataSet, mp=jmp),
        'port': SimpleNamespace(cc=tcc, Circuit=TCircuit, Label=TLabel, DataSet=TDataSet,
                                mp=tmp)}
OPS = [('Gxpi2', 0), ('Gypi2', 0)]


def strs(circuits):
    return [None if c is None else (c.str if hasattr(c, 'str') else [str(l) for l in c])
            for c in circuits]


def _labels(pkg):
    return [pkg.Label(*o) for o in OPS]


CASES = {
    'to_circuits': lambda p: strs(p.cc.to_circuits([(l,) for l in _labels(p)], line_labels=(0,))),
    'repeat': lambda p: p.cc.repeat(p.Circuit('GxGy'), 3).str,
    'repeat_count_with_max_length': lambda p: [
        p.cc.repeat_count_with_max_length(p.Circuit(s), L)
        for s in ('Gx', 'GxGy', 'GxGyGy') for L in (1, 5, 8)],
    'list_all_circuits_onelen': lambda p: strs(p.cc.list_all_circuits_onelen(_labels(p), 3)),
    'list_all_circuits': lambda p: strs(p.cc.list_all_circuits(_labels(p), 0, 3)),
    'iter_all_circuits': lambda p: strs(p.cc.iter_all_circuits(_labels(p), 1, 2)),
    'without_powers_and_cycles': lambda p: strs(
        p.cc.list_all_circuits_without_powers_and_cycles(_labels(p) + [p.Label('Gi', 0)], 4)),
    'list_random_circuits_onelen': lambda p: strs(
        p.cc.list_random_circuits_onelen(_labels(p), 6, 10, seed=2026)),
    'list_partial_circuits': lambda p: [strs([p.Circuit(t)]) for t in
                                        p.cc.list_partial_circuits(p.Circuit('GxGyGxGx'))],
    'translate_circuits': lambda p: strs(p.cc.translate_circuits(
        [p.Circuit('GxGyGx@(0)'), p.Circuit('Gy@(0)')],
        {p.Label('Gx'): (p.Label('Gy'), p.Label('Gy'))})),
    'translate_circuit_none': lambda p: p.cc.translate_circuit(p.Circuit('GxGy'), None).str,
    'filter_circuits': lambda p: [strs(p.cc.filter_circuits(
        [p.Circuit('Gx:0Gy:1@(0,1)'), p.Circuit('Gx:0@(0,1)'), p.Circuit('Gcnot:0:1@(0,1)')],
        [0], drop=drop)) for drop in (False, True)],
    'filter_circuit': lambda p: strs([p.cc.filter_circuit(p.Circuit('Gx:1Gx:0@(0,1)'), [1]),
                                      p.cc.filter_circuit(p.Circuit('Gx:1@(0,1)'), [1])]),
    'create_circuits': lambda p: strs(p.cc.create_circuits(
        'f0+germ*e+f1', 'germ', '', f0=p.mp.prep_fiducials()[:3], f1=p.mp.meas_fiducials()[:2],
        germ=p.mp.germs()[:3], e=2)),
    'create_circuits_order': lambda p: strs(p.cc.create_circuits(
        'a+b', a=[p.Circuit('Gx'), p.Circuit('Gy')], b=(p.Circuit('Gi'), p.Circuit('Gz')),
        order=['b', 'a'])),
    'create_lgst_circuits': lambda p: strs(p.cc.create_lgst_circuits(
        p.mp.prep_fiducials(), p.mp.meas_fiducials(), p.mp.target_model('full TP'))),
    'create_lgst_circuits_labels': lambda p: strs(p.cc.create_lgst_circuits(
        p.mp.prep_fiducials()[:2], p.mp.meas_fiducials()[:3], _labels(p))),
    'list_circuits_lgst_can_estimate': lambda p: strs(_lgst_estimatable(p)),
    'manipulate_circuits': lambda p: strs(p.cc.manipulate_circuits(
        [p.Circuit('GxGyGxGy'), p.Circuit('GyGx')],
        [((p.Label('Gx'), p.Label('Gy')), (p.Label('Gz'),)), ((p.Label('Gy'),), ())])),
    'manipulate_circuit_lines': lambda p: [
        p.cc.manipulate_circuit(p.Circuit('GxGx@(0)'), None).str,
        p.cc.manipulate_circuit(p.Circuit('GxGx@(0)'), [((p.Label('Gx'),), (p.Label('Gy'),))],
                                line_labels=(1,)).str],
    'repeat_with_max_length': lambda p: [p.cc.repeat_with_max_length(p.Circuit(s), L).str
                                         for s in ('GxGy', 'GxGyGy', '{}') for L in (1, 4, 7)],
    'repeat_and_truncate': lambda p: [p.cc.repeat_and_truncate(p.Circuit(s), L).str
                                      for s in ('GxGy', 'GxGyGy') for L in (1, 4, 7)],
}


def _lgst_estimatable(p):
    ds = p.DataSet()
    for c in p.cc.create_lgst_circuits(p.mp.prep_fiducials(), p.mp.meas_fiducials(),
                                       p.mp.target_model('full TP')):
        ds.add_count_dict(c, {'0': 1, '1': 1})
    return p.cc.list_circuits_lgst_can_estimate(ds, p.mp.prep_fiducials(),
                                                p.mp.meas_fiducials())


@pytest.mark.parametrize('case', sorted(CASES))
def test_circuitconstruction_matches_jax(case):
    got = {name: CASES[case](pkg) for name, pkg in PKGS.items()}
    assert got['port'] == got['jax']
    assert got['port'] not in (None, [], '')


def test_create_circuits_parses_a_string_template():
    """A template that evaluates to a string: the JAX package imports a
    module-level parse_circuit that its stdinput lacks and raises
    ImportError; the port parses the string."""
    with pytest.raises(ImportError):
        jcc.create_circuits('g + "Gy"', g=['Gx', 'Gi'])
    assert strs(tcc.create_circuits('g + "Gy"', g=['Gx', 'Gi'])) == ['GxGy', 'GiGy']
