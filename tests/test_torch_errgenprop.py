"""The port's error-generator propagation (errorgenpropagation/,
tools/errgenalgebra.py, tools/errgenproptools.py) against the JAX
package's on the same inputs: propagation through a seeded 4-qubit random
Clifford circuit of depth 10, the BCH, Magnus and Zassenhaus combinations,
the stabilizer probability corrections, and the numerical commutators and
compositions against the analytic ones.  Both packages do this on the host
in the same arithmetic; dicts agree label for label within 1e-12."""

import numpy as np
import pytest

from pygsti_tpu.circuits.circuit import Circuit as JCircuit
from pygsti_tpu.errorgenpropagation import errorpropagator as jprop
from pygsti_tpu.tools import errgenproptools as jtools, symplectic as jsym

from pygsti_tpu_torch.circuits.circuit import Circuit as TCircuit
from pygsti_tpu_torch.errorgenpropagation import errorpropagator as tprop
from pygsti_tpu_torch.tools import errgenproptools as ttools, errgenalgebra as talg
from pygsti_tpu_torch.tools import symplectic as tsym

TOL = 1e-12
GATE_ERRS = {'Gxpi2': {('H', 'Z'): 0.001, ('S', 'X'): 0.0005},
             'Gypi2': {('H', 'X'): 0.001, ('S', 'Y'): 0.0005},
             'Gcnot': {('S', 'ZZ'): 0.002, ('H', 'XX'): 0.001, ('C', 'XI', 'IZ'): 0.0003,
                       ('A', 'ZI', 'IX'): 0.0002}}


def _key(lbl):
    return (lbl[0],) + tuple(tuple(p) for p in lbl[1:])


def _same_dicts(a, b, tol=TOL):
    ka = {_key(k): v for k, v in a.items()}
    kb = {_key(k): v for k, v in b.items()}
    assert set(ka) == set(kb)
    assert max((abs(ka[k] - kb[k]) for k in ka), default=0.0) <= tol


def _circuit_gates(n, depth, seed):
    """The layers of bench.py's random Clifford circuit at n qubits."""
    rng = np.random.RandomState(seed)
    gates = []
    for dpt in range(depth):
        if dpt % 2 == 0:
            for q in range(n):
                gates.append((['Gxpi2', 'Gypi2'][rng.randint(2)], q))
        else:
            for q in range(rng.randint(2), n - 1, 2):
                gates.append(('Gcnot', q, q + 1))
    return gates


@pytest.fixture(scope='module')
def propagated():
    """Both packages' propagated generators at 4 qubits and depth 10."""
    n = 4
    gates = _circuit_gates(n, 10, 7)
    out = {}
    for order in (1, 2):
        j = jprop.ErrorGeneratorPropagator.from_errorgen_dict(GATE_ERRS, n, tuple(range(n)))
        t = tprop.ErrorGeneratorPropagator.from_errorgen_dict(GATE_ERRS, n, tuple(range(n)))
        out[order] = (j.propagate_errorgens(JCircuit(gates, tuple(range(n))), bch_order=order),
                      t.propagate_errorgens(TCircuit(gates, tuple(range(n))), bch_order=order))
    return out


@pytest.mark.parametrize('order', [1, 2])
def test_propagate_errorgens_matches_jax(propagated, order):
    j, t = propagated[order]
    assert len(t) > 10
    _same_dicts(j, t)


def test_transform_maps_and_channel_match_jax():
    n = 2
    labels = [('H', 'ZI'), ('S', 'XY'), ('C', 'XI', 'ZZ'), ('A', 'YI', 'IZ')]
    jl = [jprop.ElementaryErrorgenLabel(l[0], *[jprop.PauliLabel.from_str(p) for p in l[1:]])
          for l in labels]
    tl = [tprop.ElementaryErrorgenLabel(l[0], *[tprop.PauliLabel.from_str(p) for p in l[1:]])
          for l in labels]
    s = 'Gxpi2:0Gcnot:0:1Gzpi2:1Gh:0@(0,1)'
    jm = jprop.ErrorGeneratorPropagator(num_qubits=n).errorgen_transform_map(
        JCircuit(s), input_labels_by_layer=[jl] * 4)
    tm = tprop.ErrorGeneratorPropagator(num_qubits=n).errorgen_transform_map(
        TCircuit(s), input_labels_by_layer=[tl] * 4)
    assert {(_key(k[0]), k[1]): (_key(v[0]), v[1]) for k, v in jm.items()} == \
        {(_key(k[0]), k[1]): (_key(v[0]), v[1]) for k, v in tm.items()}
    errs = {'Gxpi2': {('H', 'Z'): 0.01, ('S', 'X'): 0.002}, 'Gcnot': {('S', 'ZZ'): 0.005}}
    c = 'Gxpi2:0Gcnot:0:1Gxpi2:1Gcnot:0:1@(0,1)'
    for order in (1, 2):
        a = jprop.ErrorGeneratorPropagator.from_errorgen_dict(errs, 2, (0, 1)) \
            .approximate_circuit_channel(JCircuit(c), bch_order=order)
        b = tprop.ErrorGeneratorPropagator.from_errorgen_dict(errs, 2, (0, 1)) \
            .approximate_circuit_channel(TCircuit(c), bch_order=order)
        assert np.max(np.abs(np.asarray(a) - b)) < 1e-12


def test_pauli_labels_and_spam_refusal():
    for s in ['XIZ', 'YYI', 'IIII', 'XYZI']:
        assert str(tprop.PauliLabel.from_str(s)) == s == str(jprop.PauliLabel.from_str(s))
        assert tuple(tprop.PauliLabel.from_str(s)) == tuple(jprop.PauliLabel.from_str(s))
    assert not tprop.PauliLabel.from_str('X').commutes_with(tprop.PauliLabel.from_str('Z'))
    prop = tprop.ErrorGeneratorPropagator.from_errorgen_dict({'Gxpi2': {('H', 'Z'): 0.01}},
                                                             1, (0,))
    with pytest.raises(NotImplementedError):
        prop.propagate_errorgens(TCircuit('Gxpi2:0@(0)'), include_spam=True)
    X, ZZ = tprop.PauliLabel.from_str('XI'), tprop.PauliLabel.from_str('ZZ')
    lbl, sign = tprop.canonicalize_errorgen_label(tprop.ElementaryErrorgenLabel('A', X, ZZ))
    assert sign == -1 and lbl[1] == ZZ and lbl[2] == X


def _halves(propagated):
    out = []
    for d in propagated[1]:
        items = list(d.items())
        out.append((dict(items[:len(items) // 2]), dict(items[len(items) // 2:])))
    return out


@pytest.mark.parametrize('order', [1, 2, 3])
def test_bch_approximation_matches_jax(propagated, order):
    (jx, jy), (tx, ty) = _halves(propagated)
    _same_dicts(jtools.bch_approximation(jx, jy, 4, bch_order=order),
                ttools.bch_approximation(tx, ty, 4, bch_order=order))


@pytest.mark.parametrize('order', [1, 2, 3])
def test_magnus_and_zassenhaus_match_jax(order):
    n = 2
    P = [(1, 0), (0, 1), (3, 2), (2, 3)]
    jl = [{jprop.ElementaryErrorgenLabel('H', jprop.PauliLabel(*p, n)): 0.02 * (i + 1),
           jprop.ElementaryErrorgenLabel('S', jprop.PauliLabel(*P[(i + 1) % 4], n)): 0.01}
          for i, p in enumerate(P)]
    tl = [{tprop.ElementaryErrorgenLabel('H', tprop.PauliLabel(*p, n)): 0.02 * (i + 1),
           tprop.ElementaryErrorgenLabel('S', tprop.PauliLabel(*P[(i + 1) % 4], n)): 0.01}
          for i, p in enumerate(P)]
    _same_dicts(jtools.magnus_expansion(jl, n, magnus_order=order),
                ttools.magnus_expansion(tl, n, magnus_order=order))
    if order <= 2:
        for a, b in zip(jtools.zassenhaus_formula(jl, n, zassenhaus_order=order),
                        ttools.zassenhaus_formula(tl, n, zassenhaus_order=order)):
            _same_dicts(a, b)


def _labels(mod, n, rng, count):
    out = []
    for _ in range(count):
        typ = 'HSCA'[rng.randint(4)]
        ps = []
        while len(ps) < (2 if typ in 'CA' else 1):
            x, z = rng.randint(1 << n), rng.randint(1 << n)
            if (x, z) != (0, 0) and (x, z) not in ps:
                ps.append((x, z))
        out.append(mod.ElementaryErrorgenLabel(typ, *[mod.PauliLabel(x, z, n) for x, z in ps]))
    return out


@pytest.mark.parametrize('n', [1, 2])
def test_numerical_commutators_match_analytic(n):
    """The dense numerical commutator and composition (the port's and the
    JAX package's) against the port's analytic bitmask algebra."""
    rng = np.random.RandomState(10 + n)
    tl = _labels(tprop, n, rng, 6)
    rng = np.random.RandomState(10 + n)
    jl = _labels(jprop, n, rng, 6)
    for (a, b), (ja, jb) in zip(zip(tl, tl[1:]), zip(jl, jl[1:])):
        num = ttools.error_generator_commutator_numerical(a, b, n)
        _same_dicts(num, ttools.error_generator_commutator(a, b, n), 1e-10)
        _same_dicts(num, jtools.error_generator_commutator_numerical(ja, jb, n), 1e-12)
        _same_dicts(ttools.error_generator_composition_numerical(a, b, n),
                    ttools.error_generator_composition(a, b, n), 1e-10)
    rates = [0.5, 2.0, -1.5]
    got = dict(ttools.iterative_error_generator_composition(tl[:3], rates, n))
    want = dict(ttools.iterative_error_generator_composition_numerical(tl[:3], rates, n))
    _same_dicts(got, want, 1e-10)
    _same_dicts(talg.layer_commutator_analytic({tl[0]: 0.3}, {tl[1]: -0.2}, n),
                dict((k, 0.3 * -0.2 * v) for k, v in
                     ttools.error_generator_commutator(tl[0], tl[1], n).items()), 1e-12)


def test_stabilizer_corrections_match_jax_and_dense():
    """alpha, the analytic corrections of orders 1-3 against the dense
    numerical ones, and both against the JAX package's, at 2 qubits."""
    n = 2
    for seed in range(3):
        s_c, p_c = tsym.random_clifford(n, np.random.RandomState(seed))
        S, P = tsym.apply_clifford_to_stabilizer_state(s_c, p_c, *tsym.prep_stabilizer_state(n))
        jS, jP = jsym.apply_clifford_to_stabilizer_state(s_c, p_c,
                                                         *jsym.prep_stabilizer_state(n))
        t_amp, j_amp = ttools.StabilizerAmplitudes(S, P), jtools.StabilizerAmplitudes(jS, jP)
        terrs = {tprop.ElementaryErrorgenLabel('S', tprop.PauliLabel(1, 0, n)): 0.05,
                 tprop.ElementaryErrorgenLabel('H', tprop.PauliLabel(0, 2, n)): 0.08,
                 tprop.ElementaryErrorgenLabel('C', tprop.PauliLabel(1, 0, n),
                                               tprop.PauliLabel(0, 1, n)): 0.01}
        jerrs = {jprop.ElementaryErrorgenLabel(k[0], *[jprop.PauliLabel(*p) for p in k[1:]]): v
                 for k, v in terrs.items()}
        for bits in ((0, 0), (0, 1), (1, 0), (1, 1)):
            assert abs(t_amp.amplitude(bits) - j_amp.amplitude(bits)) < TOL
            for (tk, tv), (jk, jv) in zip(terrs.items(), jerrs.items()):
                assert abs(ttools.alpha(tk, S, P, bits) - jtools.alpha(jk, jS, jP, bits)) < TOL
            for order in (1, 2, 3):
                a = ttools.stabilizer_probability_correction(terrs, S, P, bits, order)
                b = ttools.stabilizer_probability_correction_numerical(terrs, S, P, bits, order)
                c = jtools.stabilizer_probability_correction(jerrs, jS, jP, bits, order)
                assert abs(a - b) < 1e-12 and abs(a - c) < TOL
                assert abs(ttools.approximate_stabilizer_probability(terrs, S, P, bits, order)
                           - jtools.approximate_stabilizer_probability(jerrs, jS, jP, bits,
                                                                       order)) < TOL


def test_circuit_outcome_probability_matches_jax():
    n = 3
    gates = _circuit_gates(n, 6, 3)
    tp = tprop.ErrorGeneratorPropagator.from_errorgen_dict(GATE_ERRS, n, tuple(range(n)))
    jp = jprop.ErrorGeneratorPropagator.from_errorgen_dict(GATE_ERRS, n, tuple(range(n)))
    for bits in ((0, 0, 0), (1, 0, 1)):
        a = ttools.approximate_circuit_outcome_probability(
            tp, TCircuit(gates, tuple(range(n))), bits, order=2)
        b = jtools.approximate_circuit_outcome_probability(
            jp, JCircuit(gates, tuple(range(n))), bits, order=2)
        assert np.isfinite(a) and abs(a - b) < TOL
