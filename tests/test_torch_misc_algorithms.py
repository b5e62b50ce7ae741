"""The port's contraction, Gram-rank analysis, GRASP, scoring and argument
checks against the JAX package's, on the cases of
tests/test_misc_algorithms.py: contract to 'TP', 'CP', 'CPTP' and 'vSPAM'
within 1e-8; max_gram_rank_and_eigenvalues (the data's singular values
exactly, the target's simulated on the CPU within 1e-12); run_grasp and
neighboring_weight_vectors equal, draw for draw."""

import importlib
import random

import numpy as np
import pytest

import pygsti_tpu.modelpacks.smq1Q_XYI as jmp
from pygsti_tpu.algorithms import grasp as jgrasp
from pygsti_tpu.algorithms import grammatrix as jgram, scoring as jscoring
from pygsti_tpu.circuits.gstcircuits import create_lsgst_circuit_lists as j_lists
from pygsti_tpu.data import simulate_data as jsim
from pygsti_tpu.io import writers as jwriters
from pygsti_tpu.tools.optools import is_cptp

import pygsti_tpu_torch.modelpacks.smq1Q_XYI as tmp
from pygsti_tpu_torch.algorithms import grasp as tgrasp
from pygsti_tpu_torch.algorithms import grammatrix as tgram, scoring as tscoring
from pygsti_tpu_torch.io import readers as treaders
from pygsti_tpu_torch.tools.argchecks import check_unsupported

# both packages' algorithms/__init__ bind the name 'contract' to the function
jcontract = importlib.import_module('pygsti_tpu.algorithms.contract')
tcontract = importlib.import_module('pygsti_tpu_torch.algorithms.contract')


def _broken(mp, how):
    m = mp.target_model('full')
    key = [k for k in m.operations.keys() if str(k) == 'Gxpi2:0'][0]
    op = m.operations[key]
    mx = np.array(op.dense() if hasattr(op, 'dense') else op.to_dense())
    if how == 'TP':
        mx[0, 1] = 0.05
    else:
        mx = mx * 1.05
    m.operations[key] = type(m.operations[key])(mx)
    return m, key


@pytest.mark.parametrize('to_what', ['TP', 'CP', 'CPTP', 'vSPAM', 'nothing'])
def test_contract_matches_jax(to_what):
    jm, jk = _broken(jmp, 'TP' if to_what == 'TP' else 'scale')
    tm, tk = _broken(tmp, 'TP' if to_what == 'TP' else 'scale')
    a = jcontract.contract(jm, to_what)
    b = tcontract.contract(tm, to_what)
    assert np.max(np.abs(np.asarray(a.to_vector()) - b.to_vector())) < 1e-8
    mx = b.operations[tk].dense()
    if to_what == 'TP':
        assert np.allclose(mx[0], [1, 0, 0, 0])
    if to_what == 'CPTP':
        assert is_cptp(mx, 'pp', tol=1e-5)
    with pytest.raises(NotImplementedError):
        tcontract.contract(tm, 'XP')


def test_gram_rank_and_eigenvalues_match_jax(tmp_path):
    jt = jmp.target_model('full TP')
    lists = j_lists(jt, jmp.prep_fiducials(), jmp.meas_fiducials(), jmp.germs(), [1])
    jds = jsim(jt.depolarize(op_noise=0.02), list(lists[-1]), 4000, seed=11)
    path = str(tmp_path / 'ds.txt')
    jwriters.write_dataset(path, jds)
    tds = treaders.read_dataset(path)
    jfixed = (list(jmp.prep_fiducials()), list(jmp.meas_fiducials()))
    tfixed = (list(tmp.prep_fiducials()), list(tmp.meas_fiducials()))
    ja = jgram.max_gram_rank_and_eigenvalues(jds, jt, fixed_lists=jfixed)
    ta = tgram.max_gram_rank_and_eigenvalues(tds, tmp.target_model('full TP'),
                                             fixed_lists=tfixed, device='cpu')
    assert ja[0] == ta[0] >= 4
    assert np.array_equal(np.asarray(ja[1]), ta[1])
    assert np.max(np.abs(np.asarray(ja[2]) - ta[2])) < 1e-12
    assert ta[2][3] > 1e-3 and ta[2][4] < 1e-10
    basis_j = jgram.max_gram_basis(list(jt.operations.keys()), jds, 2)
    basis_t = tgram.max_gram_basis(list(tmp.target_model().operations.keys()), tds, 2)
    assert [tuple(str(l) for l in b) for b in basis_j] == \
        [tuple(str(l) for l in b) for b in basis_t]


def _grasp_setup():
    elements = list(range(10))
    value = {i: (i % 4) + 1 for i in elements}

    def score(sub):
        return (len(sub), -sum(value[e] for e in sub))

    def rcl(scores):
        best = min(scores)
        return [i for i, s in enumerate(scores) if s == best]

    return elements, value, score, rcl


@pytest.mark.parametrize('shuffle', [False, True])
def test_neighboring_weight_vectors_match_jax(shuffle):
    w = np.array([1, 0, 1, 0, 1, 0])
    for forced in (None, [1, 0, 0, 0, 0, 0]):
        random.seed(3)
        a = jgrasp.neighboring_weight_vectors(w, forced, shuffle)
        random.seed(3)
        b = tgrasp.neighboring_weight_vectors(w, forced, shuffle)
        assert [list(x) for x in a] == [list(x) for x in b]
        assert all(nb.sum() == 3 for nb in b)


@pytest.mark.parametrize('seed', [7, 8, 9])
def test_run_grasp_matches_jax(seed):
    elements, value, score, rcl = _grasp_setup()

    def feasible(sub):
        return sum(value[e] for e in sub) >= 10

    out = [mod.run_grasp(elements, score, rcl, score, mod.neighboring_weight_vectors, score,
                         iterations=4, feasible_fn=feasible, seed=seed)
           for mod in (jgrasp, tgrasp)]
    assert out[0] == out[1] and feasible(out[1]) and len(out[1]) == 3
    it = [mod.run_grasp_iteration(elements, score, rcl, score, mod.neighboring_weight_vectors,
                                  feasible_threshold=(6, -12), rng=random.Random(seed))
          for mod in (jgrasp, tgrasp)]
    assert it[0] == it[1] and score(it[1][1]) < (6, -12)


def test_scoring_and_argchecks_match_jax():
    ev = np.array([3.0, 1e-3, 0.5, -2.0])
    for f in ('all', 'worst'):
        assert jscoring.list_score(ev, f) == tscoring.list_score(ev, f)
    with pytest.raises(ValueError):
        tscoring.list_score(ev, 'bad')
    js = [jscoring.CompositeScore(-m, s, m) for m, s in ((3, 2.0), (3, 1.0), (2, 0.5), (3, 5.0))]
    ts = [tscoring.CompositeScore(-m, s, m) for m, s in ((3, 2.0), (3, 1.0), (2, 0.5), (3, 5.0))]
    assert sorted(range(4), key=lambda i: js[i]) == sorted(range(4), key=lambda i: ts[i])
    for alpha in (0.0, 0.3, 1.0):
        assert jscoring.composite_rcl_fn(js, alpha) == tscoring.composite_rcl_fn(ts, alpha)
        assert list(jscoring.filter_composite_rcl(js, alpha)) == \
            list(tscoring.filter_composite_rcl(ts, alpha))
    check_unsupported('f', a=(1, (1, 2)), b=((1, 2), ((1, 2),)))
    with pytest.raises(NotImplementedError, match="f: a=3 is not supported"):
        check_unsupported('f', a=(3, (1, 2)))
