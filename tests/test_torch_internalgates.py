"""tools/internalgates.py and baseobjs/unitarygatefunction.py of the port
against the JAX package's: the unitary table (1e-12), the parameterized
gates on seeded arguments (1e-12), the reverse lookup, and the gate-name
tables of OpenQASM, qiskit, quil and CHP (equal).  cirq and stim are
absent here, so their tables raise ImportError in both packages.
"""

import numpy as np
import pytest

from pygsti_tpu.tools import internalgates as jig

from pygsti_tpu_torch.baseobjs.unitarygatefunction import UnitaryGateFunction
from pygsti_tpu_torch.tools import internalgates as tig

PARAMETERIZED = ('Gzr', 'Gczr', 'Gu3')


def test_unitary_table():
    ours, theirs = tig.standard_gatename_unitaries(), jig.standard_gatename_unitaries()
    assert list(ours) == list(theirs)
    for name, u in theirs.items():
        if name in PARAMETERIZED:
            assert isinstance(ours[name], UnitaryGateFunction) and callable(ours[name])
            assert ours[name].shape == u.shape
        else:
            assert np.max(np.abs(ours[name] - u)) < 1e-12, name
    assert tig.standard_gatenames_unitary_conversions() is ours


@pytest.mark.parametrize('name', PARAMETERIZED)
def test_parameterized_gates(name):
    rng = np.random.default_rng(len(name))
    for _ in range(5):
        args = rng.uniform(-np.pi, np.pi, 3 if name == 'Gu3' else 1)
        u = getattr(tig, name)()(args)
        assert np.max(np.abs(u - getattr(jig, name)()(args))) < 1e-12
        assert np.allclose(u @ u.conj().T, np.eye(u.shape[0]), atol=1e-12)
    if name != 'Gu3':
        theta = (0.3,)
        assert np.max(np.abs(tig.unitary_from_gatename(name, theta)
                             - jig.unitary_from_gatename(name, theta))) < 1e-12
    th, ph, la = 0.4, -1.1, 2.2
    for output in ('unitary', 'superoperator'):
        assert np.max(np.abs(tig.qasm_u3(th, ph, la, output)
                             - jig.qasm_u3(th, ph, la, output))) < 1e-12


def test_internal_gate_unitaries_and_reverse_lookup():
    ours, theirs = tig.internal_gate_unitaries(), jig.internal_gate_unitaries()
    assert list(ours) == list(theirs)
    std = tig.standard_gatename_unitaries()
    rng = np.random.default_rng(11)
    for name, u in std.items():
        if name in PARAMETERIZED:
            continue
        assert tig.unitary_to_standard_gatename(u) == jig.unitary_to_standard_gatename(u)
        found = tig.unitary_to_standard_gatename(u)
        assert np.allclose(std[found], u)          # the first name of that matrix
        phase = np.exp(1j * rng.uniform(0, 2 * np.pi))
        for rp in (False, True):
            a = tig.unitary_to_standard_gatename(phase * u, up_to_phase=True, return_phase=rp)
            b = jig.unitary_to_standard_gatename(phase * u, up_to_phase=True, return_phase=rp)
            if rp:
                assert a[0] == b[0] and abs(a[1] - b[1]) < 1e-12
            else:
                assert a == b
        assert tig.is_gate_this_standard_unitary(phase * u, name) == \
            jig.is_gate_this_standard_unitary(phase * u, name) is True
        assert tig.unitary_from_gatename(name) is std[name]
    assert tig.unitary_to_standard_gatename(np.diag([1, 1j, 1, 1])) is None
    for name in ('Gxpi', 'Gh', 'Gcnot', 'Gc7', 'Gxpi2'):
        u = std[name]
        pauli = np.kron(*[np.array([[0, 1], [1, 0]])] * 2) if u.shape[0] == 4 \
            else np.array([[0, 1], [1, 0]])
        for g in (u, pauli @ u):
            assert tig.is_gate_pauli_equivalent_to_this_standard_unitary(g, name) == \
                jig.is_gate_pauli_equivalent_to_this_standard_unitary(g, name)


@pytest.mark.parametrize('table', ['standard_gatenames_chp_conversions',
                                   'standard_gatenames_qiskit_conversions',
                                   'qiskit_gatenames_standard_conversions',
                                   'standard_gatenames_quil_conversions'])
def test_name_tables(table):
    assert getattr(tig, table)() == getattr(jig, table)()


def test_openqasm_table():
    names, fns = tig.standard_gatenames_openqasm_conversions()
    jnames, jfns = jig.standard_gatenames_openqasm_conversions()
    assert names == jnames and sorted(fns) == sorted(jfns)
    for k in fns:
        assert fns[k]((0.25,)) == jfns[k]((0.25,))
    with pytest.raises(ValueError):
        tig.standard_gatenames_openqasm_conversions('u2')


@pytest.mark.parametrize('table', ['standard_gatenames_cirq_conversions',
                                   'cirq_gatenames_standard_conversions',
                                   'standard_gatenames_stim_conversions'])
def test_cirq_and_stim_tables_need_their_packages(table):
    for mod in (tig, jig):
        with pytest.raises(ImportError):
            getattr(mod, table)()
