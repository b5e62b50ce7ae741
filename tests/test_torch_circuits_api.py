"""The circuit editing methods, CompressedCircuit, SeparatePOVMCircuit,
validate_line_labels, CircuitLabel, LabelTupTupWithArgs, CircuitPlaquette
and subcircuit selection of the port against the JAX package's, on the
cases of tests/test_circuits.py and tests/test_api_surface.py and on the
2-qubit GST design at maxL 4.  Circuits compare by their strings (each
package's own type); the selection draws from the same seeds.
"""

import pickle

import numpy as np
import pytest

import pygsti_tpu.modelpacks.smq2Q_XYICNOT as jmp2
from pygsti_tpu.baseobjs.label import CircuitLabel as JCircuitLabel
from pygsti_tpu.baseobjs.label import Label as JLabel
from pygsti_tpu.baseobjs.label import LabelTupTupWithArgs as JLabelTupTupWithArgs
from pygsti_tpu.circuits import circuit as jcirc
from pygsti_tpu.circuits.circuitstructure import CircuitPlaquette as JPlaquette
from pygsti_tpu.circuits.gstcircuits import create_lsgst_circuit_lists as j_lists
from pygsti_tpu.circuits.subcircuit_selection import (restrict_circuit as j_restrict,
                                                      sample_subcircuits as j_sample)

import pygsti_tpu_torch.modelpacks.smq2Q_XYICNOT as tmp2
from pygsti_tpu_torch.baseobjs.label import CircuitLabel, Label, LabelTupTupWithArgs
from pygsti_tpu_torch.circuits.circuit import (Circuit, CompressedCircuit, SeparatePOVMCircuit,
                                               validate_line_labels)
from pygsti_tpu_torch.circuits.circuitparser import parse_circuit_str
from pygsti_tpu_torch.circuits.circuitstructure import CircuitPlaquette
from pygsti_tpu_torch.circuits.gstcircuits import create_lsgst_circuit_lists as t_lists
from pygsti_tpu_torch.circuits.subcircuit_selection import (restrict_circuit,
                                                            sample_subcircuits)


def both(layers, line_labels=None):
    return (Circuit(layers, line_labels=line_labels),
            jcirc.Circuit(layers, line_labels=line_labels))


def same(a, b):
    """Two circuits (port, JAX), or two results of the same method."""
    if isinstance(a, Circuit):
        return a.str == b.str and a.line_labels == b.line_labels and len(a) == len(b)
    return a == b


@pytest.fixture(scope='module')
def design():
    """(port circuits, JAX circuits) of smq2Q_XYICNOT's design to maxL 4."""
    t = t_lists(tmp2.target_model('full'), tmp2.prep_fiducials(), tmp2.meas_fiducials(),
                tmp2.germs(), [1, 2, 4])[-1]
    j = j_lists(jmp2.target_model('full'), jmp2.prep_fiducials(), jmp2.meas_fiducials(),
                jmp2.germs(), [1, 2, 4])[-1]
    assert [c.str for c in t] == [c.str for c in j]
    return list(t), list(j)


EDITS = [('insert_layer', (('Gzpi2', 0), 1)), ('delete_layers', (1,)),
         ('delete_layers', ([0, 2],)), ('replace_gatename', ('Gxpi2', 'Gzpi2')),
         ('replace_layer', (('Gxpi2', 0), ('Gypi2', 0))), ('layer', (1,)),
         ('layer_label', (0,)), ('idling_lines', ()), ('delete_idling_lines', ()),
         ('delete_idle_layers', ()), ('parallelize', ()), ('num_nq_gates', (1,)),
         ('two_q_gate_count', ())]


@pytest.mark.parametrize('method,args', EDITS, ids=['%s-%d' % (m, i) for i, (m, _) in
                                                     enumerate(EDITS)])
def test_editing_methods(method, args):
    for layers, lls in (([('Gxpi2', 0), ('Gypi2', 1), ('Gcnot', 0, 1)], (0, 1)),
                        ([('Gxpi2', 0), ('Gypi2', 1)], (0, 1, 2)),
                        ("Gxpi2:0[]Gypi2:0@(0)", None)):
        t, j = both(layers, lls)
        assert same(getattr(t, method)(*args), getattr(j, method)(*args)), (layers, method)


def test_the_cases_of_the_jax_tests():
    """tests/test_circuits.py:190-230, on the port."""
    c = Circuit([('Gxpi2', 0), ('Gypi2', 1), ('Gcnot', 0, 1)], line_labels=(0, 1))
    assert (c.num_gates, c.num_multiq_gates, c.num_nq_gates(1)) == (3, 1, 2)
    c2 = c.insert_layer(('Gzpi2', 0), 1)
    assert c2.depth == 4 and c2.layer(1).name == 'Gzpi2' and c2.delete_layers(1) == c
    r = c.replace_gatename('Gxpi2', 'Gzpi2')
    assert r.layer(0).name == 'Gzpi2' and r.layer(0).sslbls == (0,)
    assert c.append_circuit(c).depth == 6 and c.prefix_circuit(c) == c + c
    c = Circuit([('Gxpi2', 0), ('Gypi2', 1)], line_labels=(0, 1, 2))
    assert c.idling_lines() == (2,) and c.delete_idling_lines().line_labels == (0, 1)
    p = c.parallelize()
    assert p.depth == 1 and len(p.layer(0).components) == 2
    assert Circuit([('Gxpi2', 0), ('Gypi2', 0)], line_labels=(0,)).parallelize().depth == 2
    c4 = Circuit("Gxpi2:0[]Gypi2:0@(0)")
    assert c4.depth == 3 and c4.delete_idle_layers().depth == 2
    assert c.reorder_lines((2, 1, 0)).line_labels == (2, 1, 0)
    with pytest.raises(ValueError):
        c.reorder_lines((0, 1))
    qasm = Circuit([('Gxpi', 0), ('Gcnot', 0, 1), ('Gh', 1)],
                   line_labels=(0, 1)).convert_to_openqasm()
    assert 'OPENQASM 2.0' in qasm and 'x q[0];' in qasm and 'cx q[0], q[1];' in qasm \
        and 'h q[1];' in qasm and 'measure' in qasm


def test_design_circuits(design):
    """Every circuit of the maxL-4 design: counts, parallelize, reordered
    lines, appending and OpenQASM equal to the JAX package's; the
    compression expands back."""
    tcs, jcs = design
    for t, j in zip(tcs, jcs):
        assert (t.num_gates, t.num_multiq_gates) == (j.num_gates, j.num_multiq_gates)
        assert same(t.parallelize(), j.parallelize())
        assert t.parallelize().num_gates == t.num_gates
        assert same(t.reorder_lines((1, 0)), j.reorder_lines((1, 0)))
        assert same(t.append_circuit(tcs[0]), j.append_circuit(jcs[0]))
        assert t.convert_to_openqasm() == j.convert_to_openqasm()
        cc = CompressedCircuit(t, min_len_to_compress=4, max_period_to_look_for=6)
        assert cc._tup == jcirc.CompressedCircuit(
            j, min_len_to_compress=4, max_period_to_look_for=6)._tup
        assert cc.expand() == t


def test_compressed_and_separate_povm_circuits():
    c = Circuit(('Gxpi2', 'Gypi2') * 30 + ('Gxpi2',), (0,))
    cc = CompressedCircuit(c)
    assert len(cc._tup) < c.depth and cc.expand() == c
    assert cc._tup == jcirc.CompressedCircuit(jcirc.Circuit(('Gxpi2', 'Gypi2') * 30 + ('Gxpi2',),
                                                            (0,)))._tup
    short = Circuit(('Gxpi2',), (0,))
    assert CompressedCircuit(short).expand() == short
    sp = SeparatePOVMCircuit(short, 'Mdefault', ['0', '1'])
    jsp = jcirc.SeparatePOVMCircuit(jcirc.Circuit(('Gxpi2',), (0,)), 'Mdefault', ['0', '1'])
    assert sp.full_effect_labels == jsp.full_effect_labels == ('Mdefault_0', 'Mdefault_1')
    assert (sp.povm_label, sp.effect_labels, len(sp), str(sp)) == \
        (jsp.povm_label, jsp.effect_labels, len(jsp), str(jsp))


def test_validate_line_labels():
    validate_line_labels([0, 1, 'Q2', '*'])
    for bad in (['bad label!'], ['Q 1']):
        with pytest.raises(ValueError):
            validate_line_labels(bad)
        with pytest.raises(ValueError):
            jcirc.validate_line_labels(bad)


def test_circuit_label_and_layer_args():
    l1, jl1 = Label('Gx', (0,)), JLabel('Gx', (0,))
    cl = CircuitLabel('box', (l1, l1), (0,), reps=3)
    jcl = JCircuitLabel('box', (jl1, jl1), (0,), reps=3)
    assert (cl.depth, cl.reps, cl.name, cl.sslbls) == (jcl.depth, jcl.reps, jcl.name, jcl.sslbls)
    assert str(cl) == str(jcl) and len(cl.expand_subcircuits()) == 6
    assert pickle.loads(pickle.dumps(cl)) == cl
    assert cl.map_state_space_labels({0: 'Q0'}).sslbls == ('Q0',)
    # the string reads back as in the JAX package: the name as a label of
    # its own, then the expanded layers
    layers, _ = parse_circuit_str(str(cl) + '@(0)')
    assert [str(x) for x in layers] == [str(x) for x in
                                        jcirc.Circuit(str(jcl) + '@(0)').layertup]
    assert [str(x) for x in layers] == ['box'] + ['Gx:0'] * 6
    la = LabelTupTupWithArgs.init((l1, Label('Gy', (1,))), ('0.5',))
    jla = JLabelTupTupWithArgs.init((jl1, JLabel('Gy', (1,))), ('0.5',))
    assert (la.args, str(la), la.sslbls) == (jla.args, str(jla), jla.sslbls)
    assert la.components == (l1, Label('Gy', (1,)))
    assert pickle.loads(pickle.dumps(la)) == la


def test_circuit_plaquette(design):
    tcs, jcs = design
    elements = {(i % 3, i // 3): i for i in range(7)}
    tp = CircuitPlaquette({k: tcs[i] for k, i in elements.items()})
    jp = JPlaquette({k: jcs[i] for k, i in elements.items()})
    assert (tp.num_rows, tp.num_cols, len(tp), tp.summary_label()) == \
        (jp.num_rows, jp.num_cols, len(jp), jp.summary_label())
    assert [c.str for c in tp.circuits] == [c.str for c in jp.circuits]
    assert [(k, c.str) for k, c in tp] == [(k, c.str) for k, c in jp]
    dbl = tp.process_circuits(lambda c: c + c)
    assert [c.str for c in dbl.circuits] == [c.str for c in
                                             jp.process_circuits(lambda c: c + c).circuits]

    class Layout:      # a layout of one element per circuit, element i = circuit i
        def __init__(self, circuits):
            self.circuits = list(circuits)

        def indices(self, c):
            i = self.circuits.index(c)
            return slice(i, i + 1)

    vec = np.arange(len(tcs), dtype=float)
    mt = tp.elementvec_to_matrix(vec, Layout(tcs))
    mj = jp.elementvec_to_matrix(vec, Layout(jcs))
    assert np.array_equal(np.isnan(mt), np.isnan(mj)) and np.allclose(mt[~np.isnan(mt)],
                                                                      mj[~np.isnan(mj)])


@pytest.mark.parametrize('seed', [1, 2, 3])
def test_subcircuit_selection(seed):
    rng = np.random.RandomState(0)
    layers = [('Gxpi2', int(rng.randint(4))) for _ in range(8)] + [('Gcnot', 1, 2)]
    t, j = both(layers, (0, 1, 2, 3))
    assert same(restrict_circuit(t, (0, 1), (2, 6)), j_restrict(j, (0, 1), (2, 6)))
    assert same(restrict_circuit(t, (1, 2)), j_restrict(j, (1, 2)))
    for kw in (dict(widths=(2,), depths=(3,), num_samples_per_shape=2),
               dict(widths=(3,), depths=(2, 4), graph_edges=[(0, 1), (1, 2), (2, 3)])):
        ours, theirs = sample_subcircuits(t, seed=seed, **kw), j_sample(j, seed=seed, **kw)
        assert sorted(ours) == sorted(theirs)
        for shape in ours:
            assert [c.str for c in ours[shape]] == [c.str for c in theirs[shape]]
            assert all(c.depth == shape[1] and c.num_lines == shape[0] for c in ours[shape])
        state = np.random.RandomState(seed)
        again = sample_subcircuits([t], rand_state=state, **kw)
        assert {k: [c.str for c in v] for k, v in again.items()} == \
            {k: [c.str for c in v] for k, v in ours.items()}
