"""The Taylor-term simulator and its polynomial stack in the port against
the JAX package: polynomial algebra, compact tapes (integer tape exact,
coefficients within 1e-15), tape evaluation and derivatives in torch
(within 1e-13 of the JAX package's and of a plain Python loop), the term
simulator's polynomials on smq1Q_XYI 'H+s' and on three short
smq2Q_XYICNOT circuits (the same monomial keys; coefficients within 1e-12
of max(1, the polynomial's largest coefficient)) for orders 1-4, the
'pruned' mode and sopm_gap, its refusals, and errgenpolytools."""

import jax
import numpy as np
import pytest
import torch

from pygsti_tpu.baseobjs import opcalc as jopcalc
from pygsti_tpu.baseobjs import polynomial as jpoly
from pygsti_tpu.circuits import Circuit as JCircuit
from pygsti_tpu.errorgenpropagation.errorpropagator import (
    ElementaryErrorgenLabel as JEL, ErrorGeneratorPropagator as JProp, PauliLabel as JPL)
from pygsti_tpu.forwardsims.termforwardsim import TermForwardSimulator as JTerm
from pygsti_tpu.modelpacks import smq1Q_XYI as jxyi
from pygsti_tpu.modelpacks import smq2Q_XYICNOT as jxycnot
from pygsti_tpu.tools import errgenpolytools as jegp
from pygsti_tpu.tools import symplectic as jsym

from pygsti_tpu_torch.baseobjs import opcalc as topcalc
from pygsti_tpu_torch.baseobjs import polynomial as tpoly
from pygsti_tpu_torch.circuits.circuit import Circuit as TCircuit
from pygsti_tpu_torch.errorgenpropagation.errorpropagator import (
    ElementaryErrorgenLabel as TEL, ErrorGeneratorPropagator as TProp, PauliLabel as TPL)
from pygsti_tpu_torch.forwardsims.termforwardsim import TermForwardSimulator as TTerm
from pygsti_tpu_torch.modelmembers.term import RankOneTerm
from pygsti_tpu_torch.modelpacks import smq1Q_XYI as txyi
from pygsti_tpu_torch.modelpacks import smq2Q_XYICNOT as txycnot
from pygsti_tpu_torch.tools import errgenpolytools as tegp

COEFF_TOL = 1e-12
EVAL_TOL = 1e-13


def py_bulk_eval(vtape, ctape, paramvec, n_polys):
    """The JAX package's plain Python tape loop (opcalc._py_bulk_eval),
    kept here as the reference of the port's torch evaluation."""
    result = np.empty(n_polys, complex)
    c = i = r = 0
    while i < vtape.size:
        n_terms = vtape[i]
        i += 1
        val = 0
        for _ in range(n_terms):
            n_vars = vtape[i]
            i += 1
            a = ctape[c]
            c += 1
            for _ in range(n_vars):
                a = a * paramvec[vtape[i]]
                i += 1
            val += a
        result[r] = val
        r += 1
    assert c == ctape.size and r == n_polys
    return result


def random_polys(pkg, seed=0, n=30, nvars=8):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        coeffs = {tuple(sorted(rng.randint(0, nvars, rng.randint(0, 4)))):
                  complex(rng.randn(), rng.randn()) for _ in range(rng.randint(1, 5))}
        out.append(pkg.Polynomial(coeffs))
    return out + [pkg.Polynomial({})]


def same_polys(jp, tp):
    """Equal keys; coefficients within COEFF_TOL of max(1, largest)."""
    assert len(jp) == len(tp)
    for a, b in zip(jp, tp):
        assert set(a.keys()) == set(b.keys())
        scale = max([1.0] + [abs(x) for x in a.values()])
        assert max((abs(a[k] - b[k]) for k in a), default=0.0) <= COEFF_TOL * scale


# -- polynomials and tapes ------------------------------------------------------

def test_polynomial_algebra():
    jp, jq = jpoly.Polynomial({(): 1.0, (0,): 2.0}), jpoly.Polynomial({(1,): 3.0, (0, 1): -1.5})
    tp, tq = tpoly.Polynomial({(): 1.0, (0,): 2.0}), tpoly.Polynomial({(1,): 3.0, (0, 1): -1.5})
    x = np.array([0.5, 2.0])
    for op in (lambda a, b: a.mult(b), lambda a, b: a + b, lambda a, b: a * 2.5 + 1,
               lambda a, b: a ** 3, lambda a, b: (a * b).deriv(0), lambda a, b: b.deriv(1)):
        r, s = op(jp, jq), op(tp, tq)
        assert dict(r) == dict(s)
        assert abs(r.evaluate(x) - s.evaluate(x)) < 1e-12
    assert tp.degree() == 1 and (tp * tq).degree() == 3
    assert str(tp * tq) == str(jp * jq)
    t = RankOneTerm(tp, (1,), (2,), 0.5).scalar_mult(-2.0)
    assert t.magnitude == 1.0 and dict(t.coeff) == {(): -2.0, (0,): -4.0}


def test_tapes_equal_and_round_trip():
    """compact / compact_polynomial_list / bulk_load equal to the JAX
    package's: the integer tape exactly, coefficients within 1e-15."""
    jps, tps = random_polys(jpoly), random_polys(tpoly)
    jv, jc = jpoly.compact_polynomial_list(jps)
    tv, tc = tpoly.compact_polynomial_list(tps)
    assert np.array_equal(jv, tv) and np.abs(jc - tc).max() <= 1e-15
    for keep in (False, True):
        a = jpoly.bulk_load_compact_polynomials(jv, jc, keep_compact=keep)
        b = tpoly.bulk_load_compact_polynomials(tv, tc, keep_compact=keep)
        if keep:
            assert all(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
                       for x, y in zip(a, b))
        else:
            assert [dict(p) for p in a] == [dict(p) for p in b] == [dict(p) for p in tps]


def test_bulk_eval_and_derivatives_in_torch():
    """Values, real values and derivative matrices within 1e-13 of the JAX
    package's and of the plain Python loop; compact_deriv's tapes equal."""
    polys = random_polys(jpoly, 1)
    vt, ct = jpoly.compact_polynomial_list(polys)
    x = np.random.RandomState(2).randn(8).astype(complex)
    n = len(polys)
    ref = py_bulk_eval(vt, ct, x, n)
    got = topcalc.bulk_eval_compact_polynomials_complex(vt, ct, x, (n,), device='cpu')
    assert np.abs(got - ref).max() < EVAL_TOL
    assert np.abs(got - jopcalc.bulk_eval_compact_polynomials_complex(vt, ct, x, (n,))).max() < EVAL_TOL
    real = topcalc.bulk_eval_compact_polynomials(vt, ct.real.copy(), x.real, (n,), device='cpu')
    assert real.dtype == np.float64 and np.abs(real - py_bulk_eval(vt, ct.real, x.real, n)).max() < EVAL_TOL
    assert abs(topcalc.abs_sum_bulk_eval_compact_polynomials_complex(vt, ct, x, n, device='cpu')
               - np.abs(ref).sum()) < EVAL_TOL
    wrt = [5, 0, 3, 7]
    a = jopcalc.bulk_eval_compact_polynomials_derivs_complex(vt, ct, wrt, x, (n, 4))
    b = topcalc.bulk_eval_compact_polynomials_derivs_complex(vt, ct, wrt, x, (n, 4), device='cpu')
    assert np.abs(a - b).max() < EVAL_TOL
    b = topcalc.bulk_eval_compact_polynomials_derivs_real(vt, ct, wrt, x, (n, 4), device='cpu')
    assert np.abs(np.real(jopcalc.bulk_eval_compact_polynomials_derivs_real(vt, ct, wrt, x, (n, 4)))
                  - b).max() < EVAL_TOL
    jdv, jdc = jopcalc.compact_deriv(vt, ct, [0, 3])
    tdv, tdc = topcalc.compact_deriv(vt, ct, [0, 3])
    assert np.array_equal(jdv, tdv) and np.abs(jdc - tdc).max() <= 1e-15
    with pytest.raises(ValueError, match='names variable'):
        topcalc.bulk_eval_compact_polynomials_complex(vt, ct, x[:3], (n,), device='cpu')


# -- the term simulator ------------------------------------------------------------

@pytest.fixture(scope='module')
def hs_models():
    """smq1Q_XYI 'H+s' moved by 0.005 randn (seed 3), in both packages."""
    jm, tm = jxyi.target_model('H+s'), txyi.target_model('H+s')
    v = jm.to_vector() + np.random.RandomState(3).randn(jm.num_params) * 0.005
    jm.from_vector(v)
    tm.from_vector(v)
    return jm, tm


ONE_Q = [[('Gxpi2', 0)], [('Gxpi2', 0), ('Gypi2', 0), ('Gxpi2', 0)], [], [('Gypi2', 0)] * 4]


@pytest.mark.parametrize('order', [1, 2, 3, 4])
def test_term_polynomials_1q(hs_models, order):
    jm, tm = hs_models
    js, ts = JTerm(jm, max_order=order), TTerm(tm, max_order=order, device='cpu')
    for layers in ONE_Q[:3] if order > 2 else ONE_Q:
        jp, jo = js.prob_polynomials(JCircuit(layers, (0,)))
        tp, to = ts.prob_polynomials(TCircuit(layers, (0,)))
        assert list(jo) == list(to)
        same_polys(jp, tp)


def test_term_probs_dprobs_and_bulk_1q(hs_models):
    """probs / dprobs (opcalc in torch) and bulk_probs (bulk_coefficients)
    within 1e-13 of the JAX package's; order-2 probabilities near the dense
    simulator's (5e-6, the JAX test's bound)."""
    jm, tm = hs_models
    js, ts = JTerm(jm, max_order=2), TTerm(tm, max_order=2, device='cpu')
    circuits = [TCircuit(l, (0,)) for l in ONE_Q]
    bulk = ts.bulk_probs(circuits)
    for layers, tc in zip(ONE_Q, circuits):
        jc = JCircuit(layers, (0,))
        a, b = js.probs(jc), ts.probs(tc)
        assert all(abs(a[o] - b[o]) < EVAL_TOL and abs(bulk[tc][o] - b[o]) < EVAL_TOL for o in a)
        da, db = js.dprobs(jc), ts.dprobs(tc)
        assert all(np.abs(np.asarray(da[o]) - db[o]).max() < EVAL_TOL for o in da)
        dense = tm.probabilities(tc, device='cpu')
        assert max(abs(b[o] - dense[o]) for o in dense) < 5e-6
    with pytest.raises(NotImplementedError):
        ts.probs(circuits[0], time=0.0)


def test_term_coefficients_match_polynomials_and_conserve_probability(hs_models):
    """bulk_coefficients' probs and dprobs against the polynomials and
    their derivatives (1e-13); outcome coefficients sum to the constant 1
    (1e-10 and 1e-12 for the higher orders)."""
    _, tm = hs_models
    ts = TTerm(tm, max_order=2, device='cpu')
    circuits = [TCircuit(l, (0,)) for l in ONE_Q]
    stats = {}
    co = ts.bulk_coefficients(circuits, stats=stats)
    assert stats['buckets'] == 4 and co.c2.shape == (4, 2, 30 * 31 // 2)
    v = tm.to_vector()
    p, dp = co.probs(v).numpy(), co.dprobs(v).numpy()
    for i, c in enumerate(circuits):
        polys, _ = ts.prob_polynomials(c)
        for e, poly in enumerate(polys):
            assert abs(poly.evaluate(v) - p[i, e]) < EVAL_TOL
            for k in (0, 7, 19, 29):
                assert abs(poly.deriv(k).evaluate(v) - dp[i, e, k]) < EVAL_TOL
    assert np.abs(co.c0.sum(1).numpy() - 1).max() < 1e-10
    assert np.abs(co.c1.sum(1).numpy()).max() < 1e-12
    assert np.abs(co.c2.sum(1).numpy()).max() < 1e-12


def test_term_pruned_mode_and_sopm_gap(hs_models):
    """'pruned' polynomials, prob_polynomials_general at a threshold, and
    sopm_gap equal to the JAX package's."""
    jm, tm = hs_models
    for layers in (ONE_Q[1], [('Gxpi2', 0), ('Gypi2', 0)] * 3):
        jc, tc = JCircuit(layers, (0,)), TCircuit(layers, (0,))
        for kw in ({'min_term_mag': 1e-6, 'allowed_perr': 1e-3}, {'min_term_mag': 1e-3}):
            js = JTerm(jm, max_order=3, mode='pruned', **kw)
            ts = TTerm(tm, max_order=3, mode='pruned', device='cpu', **kw)
            same_polys(js.prob_polynomials(jc)[0], ts.prob_polynomials(tc)[0])
            ja, jmx = js.sopm_gap(jc)
            ta, tmx = ts.sopm_gap(tc)
            assert abs(ja - ta) < 1e-12 and abs(jmx - tmx) < 1e-12
            pa, pb = js.probs(jc), ts.probs(tc)
            assert all(abs(pa[o] - pb[o]) < EVAL_TOL for o in pa)
        a = JTerm(jm, max_order=3).prob_polynomials_general(jc, min_term_mag=1e-5)
        b = TTerm(tm, max_order=3, device='cpu').prob_polynomials_general(tc, min_term_mag=1e-5)
        same_polys(a[0], b[0])
        assert abs(a[2] - b[2]) < 1e-12 and abs(a[3] - b[3]) < 1e-12


TWO_Q = [[('Gxpi2', 0), ('Gcnot', 0, 1), ('Gypi2', 1)], [],
         [('Gypi2', 0), ('Gxpi2', 1)] * 2]


@pytest.fixture(scope='module')
def hs_models_2q():
    """smq2Q_XYICNOT 'H+s' (240 parameters) moved by 0.001 randn (seed 3)."""
    jm, tm = jxycnot.target_model('H+s'), txycnot.target_model('H+s')
    v = jm.to_vector() + np.random.RandomState(3).randn(jm.num_params) * 0.001
    jm.from_vector(v)
    tm.from_vector(v)
    return jm, tm


@pytest.mark.parametrize('i', range(len(TWO_Q)))
def test_term_polynomials_2q(hs_models_2q, i):
    jm, tm = hs_models_2q
    jp, _ = JTerm(jm, max_order=2).prob_polynomials(JCircuit(TWO_Q[i], (0, 1)))
    ts = TTerm(tm, max_order=2, device='cpu')
    tp, _ = ts.prob_polynomials(TCircuit(TWO_Q[i], (0, 1)))
    same_polys(jp, tp)
    co = ts.bulk_coefficients([TCircuit(l, (0, 1)) for l in TWO_Q])
    assert np.abs(co.c0.sum(1).numpy() - 1).max() < 1e-10


def test_term_simulator_refusals(hs_models):
    """'CPTPLND' (not linear in its parameters) and 'full TP' (no error
    generator) raise ValueError, as in the JAX package; float32 raises
    ValueError naming float64."""
    for param in ('CPTPLND', 'full TP'):
        tm = txyi.target_model(param)
        with pytest.raises(ValueError, match='[Tt]erm simulator'):
            TTerm(tm, max_order=1, device='cpu').probs(TCircuit([('Gxpi2', 0)], (0,)))
        with pytest.raises(ValueError, match='[Tt]erm simulator'):
            JTerm(jxyi.target_model(param), max_order=1).probs(JCircuit([('Gxpi2', 0)], (0,)))
    with pytest.raises(ValueError, match='float64'):
        TTerm(hs_models[1], dtype=torch.float32, device='cpu')
    with pytest.raises(ValueError, match='orders 0-2'):
        TTerm(hs_models[1], max_order=3, device='cpu').bulk_coefficients([TCircuit([], (0,))])


def test_jax_term_simulator_rejects_h_plus_s_without_x64(hs_models):
    """The JAX package's decomposition checks linearity at 1e-9 in the
    default dtype: without x64 it rejects even 'H+s' gates as nonlinear.
    The port works at float64 whatever the default and refuses float32
    outright."""
    jm, tm = hs_models
    with jax.enable_x64(False):
        with pytest.raises(ValueError, match='param-linear'):
            JTerm(jm).probs(JCircuit([('Gxpi2', 0)], (0,)))
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float32)
    try:
        p = TTerm(tm, device='cpu').probs(TCircuit([('Gxpi2', 0)], (0,)))
    finally:
        torch.set_default_dtype(prev)
    assert abs(sum(p.values()) - 1.0) < 1e-12


def test_cubic_convergence():
    """Order-2 truncation error falls by 5-12 when the rates halve (the
    JAX test's band), on the port alone."""
    c = TCircuit([('Gxpi2', 0), ('Gypi2', 0), ('Gxpi2', 0)], (0,))
    noise = np.random.RandomState(3).randn(30)
    errs = []
    for scale in (0.01, 0.005):
        m = txyi.target_model('H+s')
        m.from_vector(m.to_vector() + noise * scale)
        p = TTerm(m, max_order=2, device='cpu').probs(c)
        dense = m.probabilities(c, device='cpu')
        errs.append(max(abs(p[o] - dense[o]) for o in dense))
    assert 5 < errs[0] / errs[1] < 12


# -- errgenpolytools -------------------------------------------------------------

def _labels(n, seed):
    rng = np.random.RandomState(seed)
    jl, tl = [], []
    for typ in 'HSCA':
        for _ in range(3):
            a = (int(rng.randint(1, 4 ** n)), )
            x, z = a[0] % (2 ** n), a[0] // (2 ** n)
            if typ in 'CA':
                b = int(rng.randint(1, 4 ** n))
                if b == a[0]:
                    b = b % (4 ** n - 1) + 1
                x2, z2 = b % (2 ** n), b // (2 ** n)
                jl.append(JEL(typ, JPL(x, z, n), JPL(x2, z2, n)))
                tl.append(TEL(typ, TPL(x, z, n), TPL(x2, z2, n)))
            else:
                jl.append(JEL(typ, JPL(x, z, n)))
                tl.append(TEL(typ, TPL(x, z, n)))
    return jl, tl


@pytest.mark.parametrize('n,seed', [(1, 0), (2, 1), (3, 2)])
def test_stabilizer_probability_polynomial(n, seed):
    """The port's sandwich expansion against the JAX package's dense one:
    the same keys, coefficients within 1e-12, every bitstring, orders 1
    and 2 (order 0: the next test)."""
    rng = np.random.RandomState(seed)
    s, p = jsym.random_clifford(n, rand_state=rng)
    out = jsym.apply_clifford_to_stabilizer_state(s, p, *jsym.prep_stabilizer_state(n))
    jl, tl = _labels(n, seed)
    for k in range(2 ** n):
        bits = [(k >> (n - 1 - q)) & 1 for q in range(n)]
        for order in (1, 2):
            a = jegp.stabilizer_probability_polynomial(jl, out[0], out[1], bits, order)
            b = tegp.stabilizer_probability_polynomial(tl, out[0], out[1], bits, order)
            same_polys([a], [b])


def test_jax_order_zero_polynomial_has_first_order_terms():
    """The JAX package's stabilizer_probability_polynomial adds the
    first-order terms whatever `order` is, so order 0 equals order 1; the
    port's order 0 is the constant alone."""
    n = 1
    s, p = jsym.random_clifford(n, rand_state=np.random.RandomState(0))
    out = jsym.apply_clifford_to_stabilizer_state(s, p, *jsym.prep_stabilizer_state(n))
    jl, tl = _labels(n, 0)
    a0 = jegp.stabilizer_probability_polynomial(jl, out[0], out[1], [0], 0)
    a1 = jegp.stabilizer_probability_polynomial(jl, out[0], out[1], [0], 1)
    b0 = tegp.stabilizer_probability_polynomial(tl, out[0], out[1], [0], 0)
    assert dict(a0) == dict(a1) and len(a0) > 1
    assert dict(b0) == {(): a0[()]}


def test_circuit_probability_polynomial():
    """End to end through both packages' propagators at 2 qubits, and the
    port's at 6 qubits against its first-order approximation."""
    errs = {'Gxpi2': {('H', 'Z'): 0.001, ('S', 'X'): 0.0005},
            'Gcnot': {('S', 'ZZ'): 0.002, ('H', 'XX'): 0.001}}
    layers = [('Gxpi2', 0), ('Gcnot', 0, 1), ('Gxpi2', 1), ('Gxpi2', 0)]
    a, la = jegp.circuit_probability_polynomial(JProp.from_errorgen_dict(errs, 2, (0, 1)),
                                                JCircuit(layers, (0, 1)), '00')
    b, lb = tegp.circuit_probability_polynomial(TProp.from_errorgen_dict(errs, 2, (0, 1)),
                                                TCircuit(layers, (0, 1)), '00')
    assert [tuple(l) for l in la] == [tuple(l) for l in lb]
    same_polys([a], [b])
    from pygsti_tpu_torch.tools.errgenproptools import approximate_circuit_outcome_probability
    prop = TProp.from_errorgen_dict(errs, 6, tuple(range(6)))
    circ = TCircuit([('Gxpi2', q) for q in range(6)] + [('Gcnot', q, q + 1) for q in range(5)],
                    tuple(range(6)))
    poly, labels = tegp.circuit_probability_polynomial(prop, circ, '0' * 6)
    rates = np.array(list(prop.propagate_errorgens(circ).values()))
    first = approximate_circuit_outcome_probability(prop, circ, '0' * 6, order=1)
    assert poly.degree() == 2 and abs(poly.evaluate(rates) - first) < 1e-4
