"""Randomized benchmarking in the port against the JAX package: the random
circuit samplers and RB designs (circuits and ideal outcomes equal for the
same seeds), the decay fits, RandomizedBenchmarking on the same counts, the
L-matrix theory, RB circuits' probabilities on a crosstalk-free model, and
the stabilizer and success/fail simulators."""

import numpy as np
import pytest

from pygsti_tpu.algorithms import mirroring as jmir
from pygsti_tpu.algorithms import randomcircuit as jrc
from pygsti_tpu.algorithms import rbfit as jfit
from pygsti_tpu.circuits.circuit import Circuit as JCircuit
from pygsti_tpu.data.dataset import DataSet as JDataSet
from pygsti_tpu.forwardsims import stabilizersim as jstab
from pygsti_tpu.forwardsims import successfailsim as jsf
from pygsti_tpu.models import modelconstruction as jmc
from pygsti_tpu.modelpacks import smq1Q_XY as jxy
from pygsti_tpu.processors.processorspec import QubitProcessorSpec as JQPS
from pygsti_tpu.protocols import rb as jrb
from pygsti_tpu.protocols.protocol import ProtocolData as JProtocolData
from pygsti_tpu.tools import group as jgroup
from pygsti_tpu.tools import rbtheory as jth
from pygsti_tpu.tools import rbtools as jtools

from pygsti_tpu_torch.algorithms import mirroring as tmir
from pygsti_tpu_torch.algorithms import randomcircuit as trc
from pygsti_tpu_torch.algorithms import rbfit as tfit
from pygsti_tpu_torch.circuits.circuit import Circuit as TCircuit
from pygsti_tpu_torch.data.dataset import DataSet as TDataSet
from pygsti_tpu_torch.forwardsims import stabilizersim as tstab
from pygsti_tpu_torch.forwardsims import successfailsim as tsf
from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
from pygsti_tpu_torch.models import modelconstruction as tmc
from pygsti_tpu_torch.modelpacks import smq1Q_XY as txy
from pygsti_tpu_torch.processors.processorspec import QubitProcessorSpec as TQPS
from pygsti_tpu_torch.protocols import rb as trb
from pygsti_tpu_torch.protocols.protocol import ProtocolData as TProtocolData
from pygsti_tpu_torch.tools import group as tgroup
from pygsti_tpu_torch.tools import rbtheory as tth
from pygsti_tpu_torch.tools import rbtools as ttools

GATES = ['Gxpi2', 'Gypi2', 'Gcnot']


def same(a, b):
    """Exact equality of nested results: arrays by value, circuits and
    labels by their strings, numbers exactly."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    if isinstance(a, dict):
        return isinstance(b, dict) and list(map(str, a)) == list(map(str, b)) and \
            all(same(x, y) for x, y in zip(a.values(), b.values()))
    if hasattr(a, 'layertup') or hasattr(a, 'sslbls'):
        return str(a) == str(b)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and \
            all(same(x, y) for x, y in zip(a, b))
    return a == b


def specs(n, gates=GATES, **kw):
    return JQPS(n, gates, geometry='line', **kw), TQPS(n, gates, geometry='line', **kw)


def _zr(args):
    th = float(args[0])
    return np.array([[np.exp(-0.5j * th), 0], [0, np.exp(0.5j * th)]])


def _czr(args):
    th = float(args[0])
    return np.diag([1, 1, np.exp(-0.5j * th), np.exp(0.5j * th)])


# (name, function of (randomcircuit module, pspec, rng))
SAMPLERS = [
    ('clifford_rb', lambda m, p, r: m.create_clifford_rb_circuit(p, None, 3, rand_state=r)),
    ('clifford_rb_randomizeout', lambda m, p, r: m.create_clifford_rb_circuit(
        p, None, 2, randomizeout=True, citerations=5, rand_state=r)),
    ('clifford_rb_interleaved', lambda m, p, r: m.create_clifford_rb_circuit(
        p, None, 2, rand_state=r, interleaved_circuit=(JCircuit if m is jrc else TCircuit)(
            [('Gxpi2', p.qubit_labels[0])], p.qubit_labels))),
    ('direct_rb', lambda m, p, r: m.create_direct_rb_circuit(p, None, 4, rand_state=r)),
    ('direct_rb_randomizeout', lambda m, p, r: m.create_direct_rb_circuit(
        p, None, 3, randomizeout=True, rand_state=r)),
    ('direct_rb_qelimination', lambda m, p, r: m.create_direct_rb_circuit(
        p, None, 3, sampler='Qelimination', rand_state=r)),
    ('direct_rb_local', lambda m, p, r: m.create_direct_rb_circuit(
        p, None, 3, sampler='local', rand_state=r)),
    ('direct_rb_addlocal_notwirl', lambda m, p, r: m.create_direct_rb_circuit(
        p, None, 3, addlocal=True, cliffordtwirl=False, conditionaltwirl=False, rand_state=r)),
    ('direct_rb_density', lambda m, p, r: m.create_direct_rb_circuit(
        p, None, 5, samplerargs={'two_q_gate_density': 0.5}, rand_state=r)),
    ('mirror_rb', lambda m, p, r: m.create_mirror_rb_circuit(p, None, 4, rand_state=r)),
    ('mirror_rb_plain', lambda m, p, r: m.create_mirror_rb_circuit(
        p, None, 2, localclifford=False, paulirandomize=False, rand_state=r)),
    ('random_circuit', lambda m, p, r: m.create_random_circuit(p, 6, rand_state=r)),
    ('random_circuit_qelim', lambda m, p, r: m.create_random_circuit(
        p, 4, sampler='Qelimination', rand_state=r)),
    ('layer_of_one_q_gates', lambda m, p, r: m.sample_circuit_layer_of_one_q_gates(
        p, rand_state=r)),
    ('edgegrab_layer', lambda m, p, r: m.sample_circuit_layer_by_edgegrab(
        p, two_q_gate_density=0.6, rand_state=r)),
    ('random_germ', lambda m, p, r: m.create_random_germ(p, [4], 0.2, p.qubit_labels,
                                                         rand_state=r)),
    ('germpower', lambda m, p, r: m.create_random_germpower_circuits(
        p, [4, 16], 0.2, p.qubit_labels, rand_state=r)),
    ('germpower_fixed', lambda m, p, r: m.create_random_germpower_circuits(
        p, [4, 8], 0.3, p.qubit_labels, fixed_versus_depth=True, rand_state=r)),
    ('one_q_clifford_layer', lambda m, p, r: m.sample_one_q_clifford_layer_as_compiled_circuit(
        p, rand_state=r)),
    ('alternating_clifford', lambda m, p, r: m.random_alternating_clifford_circ(
        p, 4, rand_state=r)),
    ('compatible_two_q_sets', lambda m, p, r: m.find_all_sets_of_compatible_two_q_gates(
        [(0, 1), (1, 2), (2, 3)][:len(p.qubit_labels) - 1], len(p.qubit_labels))),
    ('unitary_parameters', lambda m, p, r: (
        m.sample_haar_random_one_qubit_unitary_parameters(r),
        m.sample_random_clifford_one_qubit_unitary_parameters(r))),
]
ZR_SAMPLERS = [
    ('haar_zxzxz', lambda m, p, r: m.sample_compiled_haar_random_one_qubit_gates_zxzxz_circuit(
        p, rand_state=r)),
    ('clifford_zxzxz', lambda m, p, r:
        m.sample_compiled_random_clifford_one_qubit_gates_zxzxz_circuit(p, rand_state=r)),
    ('cz_zxzxz', lambda m, p, r: m.sample_random_cz_zxzxz_circuit(
        p, 3, qubit_labels=p.qubit_labels, rand_state=r)),
]


# samplers that need an edge run on 2 and 3 qubits only
TWO_QUBIT = ('mirror_rb', 'compatible_two_q_sets', 'random_circuit_qelim',
             'direct_rb_qelimination')


@pytest.mark.parametrize("n, case", [(n, c) for n in (1, 2, 3) for c in SAMPLERS
                                     if n > 1 or c[0] not in TWO_QUBIT],
                         ids=lambda x: x[0] if isinstance(x, tuple) else str(x))
def test_samplers(n, case):
    """Circuits (as strings) and ideal outcomes equal for the same seed."""
    name, fn = case
    jp, tp = specs(n, GATES if n > 1 else ['Gxpi2', 'Gypi2'])
    for seed in range(2):
        a = fn(jrc, jp, np.random.RandomState(seed))
        b = fn(trc, tp, np.random.RandomState(seed))
        assert same(a, b), (name, a, b)


@pytest.mark.parametrize("case", ZR_SAMPLERS, ids=lambda c: c[0])
def test_zxzxz_samplers(case):
    """The ZXZXZ samplers over Gzr/Gxpi2/Gczr (the port takes Gzr and Gczr
    as functions of their angle)."""
    _, fn = case
    gates = ['Gzr', 'Gxpi2', 'Gczr']
    jp = JQPS(3, gates, geometry='line')
    tp = TQPS(3, gates, geometry='line', nonstd_gate_unitaries={'Gzr': _zr, 'Gczr': _czr})
    for seed in range(3):
        a = fn(jrc, jp, np.random.RandomState(seed))
        b = fn(trc, tp, np.random.RandomState(seed))
        assert same(a, b)


@pytest.mark.parametrize("opts", [{}, {'layer_sampling': 'alternating1q2q', 'addlocal': True}])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_binary_rb_circuits(n, opts):
    """create_binary_rb_circuit: the JAX package compiles the random
    preparation with an unseeded generator, so at 3 qubits one seed gives
    other circuits each call; the port seeds it from `seed`.  The measured
    Pauli, its sign and the circuit's Clifford are the JAX package's; the
    circuit strings too up to 2 qubits, where every elimination order
    compiles alike."""
    from pygsti_tpu.tools import symplectic as jsym
    from pygsti_tpu_torch.tools import symplectic as tsym
    jp, tp = specs(n, GATES + ['Gxpi'] if n > 1 else ['Gxpi2', 'Gypi2', 'Gxpi'])
    for seed in range(3):
        a = jrc.create_binary_rb_circuit(jp, None, 3, seed=seed, **opts)
        b = trc.create_binary_rb_circuit(tp, None, 3, seed=seed, **opts)
        assert same(b, trc.create_binary_rb_circuit(tp, None, 3, seed=seed, **opts))
        assert a[1:] == b[1:]
        assert same(jsym.symplectic_rep_of_clifford_circuit(a[0]),
                    tsym.symplectic_rep_of_clifford_circuit(b[0]))
        if n <= 2:
            assert a[0].str == b[0].str


def test_pauli_layer_where_the_jax_package_raises():
    """sample_pauli_layer_as_compiled_circuit: the JAX package raises
    KeyError wherever it draws an identity (it has no word for 'I'); the
    port compiles the identity to no gate.  Where no identity is drawn the
    circuits are equal; the port's always implements the drawn Pauli."""
    from pygsti_tpu_torch.tools import symplectic as tsym
    jp, tp = specs(3)
    names = ['Gi', 'Gxpi', 'Gypi', 'Gzpi']
    raised = 0
    for seed in range(12):
        drawn = np.random.RandomState(seed).randint(0, 4, size=3)
        b = trc.sample_pauli_layer_as_compiled_circuit(
            tp, keepidle=True, rand_state=np.random.RandomState(seed))
        if (drawn == 0).any():
            with pytest.raises(KeyError):
                jrc.sample_pauli_layer_as_compiled_circuit(
                    jp, keepidle=True, rand_state=np.random.RandomState(seed))
            raised += 1
        else:
            a = jrc.sample_pauli_layer_as_compiled_circuit(
                jp, keepidle=True, rand_state=np.random.RandomState(seed))
            assert a.str == b.str
        sreps = tsym.compute_internal_gate_symplectic_representations(names)
        want = tsym.symplectic_kronecker([sreps[names[k]] for k in drawn])
        got = tsym.symplectic_rep_of_clifford_circuit(b)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1] % 4, want[1] % 4)
    assert 0 < raised < 12
    seed = next(x for x in range(50) if np.random.RandomState(x).randint(0, 4, size=1)[0] == 0)
    ident = trc.sample_pauli_layer_as_compiled_circuit(
        TQPS(1, ['Gxpi2', 'Gypi2']), keepidle=True, rand_state=np.random.RandomState(seed))
    assert ident.depth == 1 and len(ident.layertup[0]) == 0   # drew 'I': one idle layer


def test_germpower_mirror_circuits_are_seeded():
    """create_random_germpower_mirror_circuits: the JAX package draws the
    mirrors' random layers from an unseeded generator, so one seed gives
    other circuits each call; the port draws them from rand_state.  The germs
    are the JAX package's, and each mirror circuit returns its outcome."""
    jp, tp = specs(2)
    runs = [trc.create_random_germpower_mirror_circuits(
        tp, None, [4, 8], qubit_labels=(0, 1), rand_state=np.random.RandomState(6))
        for _ in range(2)]
    assert same(runs[0], runs[1])
    _, _, jaux = jrc.create_random_germpower_mirror_circuits(
        jp, None, [4, 8], qubit_labels=(0, 1), rand_state=np.random.RandomState(6))
    assert same(jaux, runs[0][2])
    sim = tstab.StabilizerForwardSimulator(tp)
    for c, out in zip(runs[0][0], runs[0][1]):
        assert abs(sim.probability(c, ''.join(out)) - 1) < 1e-12


def test_create_mirror_circuit():
    """create_mirror_circuit of Clifford circuits: equal circuits and
    outcomes, and the mirror brings |00> back to its outcome."""
    jp, tp = specs(2)
    for seed in range(3):
        jc = jrc.create_random_circuit(jp, 4, rand_state=np.random.RandomState(seed))
        tc = trc.create_random_circuit(tp, 4, rand_state=np.random.RandomState(seed))
        a = jmir.create_mirror_circuit(jc, jp, circ_type='clifford', seed=seed)
        b = tmir.create_mirror_circuit(tc, tp, circ_type='clifford', seed=seed)
        assert same(a, b)
        p = tstab.StabilizerForwardSimulator(tp).probability(b[0], ''.join(b[1]))
        assert abs(p - 1) < 1e-12


def _design(mod, pspec, kind, seed):
    if kind == 'clifford':
        return mod.CliffordRBDesign(pspec, None, [0, 1, 3], 3, seed=seed, citerations=4)
    if kind == 'direct':
        return mod.DirectRBDesign(pspec, None, [0, 2, 6], 3, seed=seed)
    if kind == 'direct_randomizeout':
        return mod.DirectRBDesign(pspec, None, [0, 4], 3, randomizeout=True, seed=seed)
    if kind == 'mirror':
        return mod.MirrorRBDesign(pspec, [0, 2, 4], 3, seed=seed)
    if kind == 'binary':
        return mod.BinaryRBDesign(pspec, None, [0, 2, 4], 3, seed=seed)
    circ = (JCircuit if mod is jrb else TCircuit)([('Gxpi2', 0)], pspec.qubit_labels)
    return mod.InterleavedRBDesign(pspec, circ, [0, 2, 4], 3, seed=seed, citerations=4)


@pytest.mark.parametrize("kind", ['clifford', 'direct', 'direct_randomizeout', 'mirror',
                                  'binary', 'interleaved'])
def test_designs(kind):
    """Every RB design: its circuits and ideal outcomes equal the JAX
    package's for the same seed."""
    jp, tp = specs(2)
    a, b = _design(jrb, jp, kind, 9), _design(trb, tp, kind, 9)
    if kind == 'interleaved':
        assert list(a.keys()) == list(b.keys())
        pairs = [(a[k], b[k]) for k in a.keys()]
    else:
        pairs = [(a, b)]
    for x, y in pairs:
        assert x.depths == y.depths
        assert same(x.circuit_lists, y.circuit_lists)
        assert same(x.idealout_lists, y.idealout_lists)
        assert same(list(x.all_circuits_needing_data), list(y.all_circuits_needing_data))


# a decay with its data: depths, average success probabilities, qubits
DECAYS = [
    ([0, 2, 4, 8, 16, 32], [0.97, 0.93, 0.90, 0.83, 0.71, 0.55], 1),
    ([0, 1, 2, 4, 8, 16, 32, 64], [0.95, 0.93, 0.91, 0.87, 0.80, 0.66, 0.48, 0.32], 2),
    ([1, 3, 5, 10, 20], [0.90, 0.84, 0.79, 0.67, 0.48], 3),
    ([0, 5, 10], [0.5, 0.5, 0.5], 1),
]


@pytest.mark.parametrize("data", DECAYS)
def test_fits(data):
    """std_least_squares_fit ('full' and 'FA'), custom_least_squares_fit
    (free, a fixed, both fixed) and p_to_r / r_to_p within 1e-10."""
    m, asps, n = data
    for kw in ({}, {'ftype': 'FA', 'asymptote': 1 / 2 ** n}, {'rtype': 'AGI'}):
        a = jfit.std_least_squares_fit(m, asps, n, **kw)
        b = tfit.std_least_squares_fit(m, asps, n, **kw)
        assert a['success'] == b['success']
        for k in 'abpr':
            assert abs(a['estimates'][k] - b['estimates'][k]) < 1e-10
    for kw in ({}, {'a': 1 / 2 ** n}, {'a': 1 / 2 ** n, 'b': asps[0] - 1 / 2 ** n}):
        a = jfit.custom_least_squares_fit(m, asps, n, **kw)
        b = tfit.custom_least_squares_fit(m, asps, n, **kw)
        assert a.success == b.success and sorted(a.estimates) == sorted(b.estimates)
        for k in a.estimates:
            assert abs(a.estimates[k] - b.estimates[k]) < 1e-10
        assert str(a) == str(b)
    for rtype in ('EI', 'AGI'):
        for d in (2, 4, 8):
            for p in (0.5, 0.9, 0.999):
                assert abs(jtools.p_to_r(p, d, rtype) - ttools.p_to_r(p, d, rtype)) < 1e-10
                assert abs(jfit.r_to_p(0.01, d, rtype) - tfit.r_to_p(0.01, d, rtype)) < 1e-10
                assert abs(ttools.r_to_p(ttools.p_to_r(p, d, rtype), d, rtype) - p) < 1e-10
    lengths = np.asarray(m, float)
    assert abs(jtools.rescaling_factor(lengths, np.asarray(asps))
               - ttools.rescaling_factor(lengths, np.asarray(asps))) < 1e-10
    assert jtools.hamming_distance('0110', '0011') == ttools.hamming_distance('0110', '0011')
    pdf = [0.7, 0.2, 0.1][:n + 1] if n < 3 else [0.6, 0.2, 0.1, 0.1]
    assert abs(jtools.adjusted_success_probability(pdf)
               - ttools.adjusted_success_probability(pdf)) < 1e-12


def _same_counts(jdesign, tdesign, seed, energies=False, shots=100):
    """Counts made once with numpy from a decay, fed to both packages."""
    rng = np.random.RandomState(seed)
    jds, tds = JDataSet(), TDataSet()
    n = len(tdesign.qubit_labels)
    outcomes = [format(i, '0%db' % n) for i in range(2 ** n)]
    for d, jcl, tcl, ideals in zip(tdesign.depths, jdesign.circuit_lists,
                                   tdesign.circuit_lists, tdesign.idealout_lists):
        for jc, tc, ideal in zip(jcl, tcl, ideals):
            if energies:
                counts = rng.multinomial(shots, np.full(2 ** n, 1 / 2 ** n))
            else:
                ps = 1 / 2 ** n + (1 - 1 / 2 ** n) * 0.97 ** (d + 1) + 0.02 * rng.randn()
                ps = min(max(ps, 0.0), 1.0)
                rest = rng.multinomial(shots, np.full(2 ** n - 1, 1 / (2 ** n - 1))) \
                    if n > 1 else np.array([shots])
                k = rng.binomial(shots, ps)
                ideal_str = ''.join(str(b) for b in ideal)
                others = [o for o in outcomes if o != ideal_str]
                counts = [0] * len(outcomes)
                counts[outcomes.index(ideal_str)] = k
                left = shots - k
                for o, c in zip(others, rest):
                    counts[outcomes.index(o)] = int(round(left * c / shots))
                counts[outcomes.index(others[0])] += shots - sum(counts)
            cd = {o: int(c) for o, c in zip(outcomes, counts)}
            jds.add_count_dict(jc, cd)
            tds.add_count_dict(tc, cd)
    return jds, tds


@pytest.mark.parametrize("kind", ['clifford', 'direct', 'mirror'])
def test_randomized_benchmarking_on_the_same_counts(kind):
    """RandomizedBenchmarking.run: r, p, A, B within 1e-9 for the 'full' and
    'A-fixed' fits, the success probabilities by depth and the bootstrap
    list equal."""
    jp, tp = specs(2)
    jd, td = _design(jrb, jp, kind, 4), _design(trb, tp, kind, 4)
    jds, tds = _same_counts(jd, td, 11)
    for kw in ({'bootstrap_samples': 30}, {'bootstrap_samples': 0, 'rtype': 'AGI'}):
        a = jrb.RandomizedBenchmarking(**kw).run(JProtocolData(jd, jds))
        b = trb.RandomizedBenchmarking(**kw).run(TProtocolData(td, tds))
        assert a.depths == b.depths and same(a.asps, b.asps)
        assert same(a.success_probs_by_depth, b.success_probs_by_depth)
        for fit in ('full', 'A-fixed'):
            for k in 'abpr':
                assert abs(a.fits[fit]['estimates'][k] - b.fits[fit]['estimates'][k]) < 1e-9
        assert a.bootstraps['full'] == b.bootstraps['full']
        assert len(b.bootstraps['full']) == kw['bootstrap_samples']
        assert (a.r_std is None) == (b.r_std is None) and str(a) == str(b)
    assert trb.RB is trb.RandomizedBenchmarking and trb.RBResults is \
        trb.RandomizedBenchmarkingResults


def test_binary_and_interleaved_protocols_on_the_same_counts():
    """BiRB ('energies') and interleaved RB on the same counts."""
    jp, tp = specs(2)
    jd, td = _design(jrb, jp, 'binary', 2), _design(trb, tp, 'binary', 2)
    jds, tds = _same_counts(jd, td, 3, energies=True)
    a = jrb.RandomizedBenchmarking('energies', bootstrap_samples=5).run(JProtocolData(jd, jds))
    b = trb.RandomizedBenchmarking('energies', bootstrap_samples=5).run(TProtocolData(td, tds))
    assert same(a.asps, b.asps) and a.bootstraps['full'] == b.bootstraps['full']
    for k in 'abpr':
        assert abs(a.fits['full']['estimates'][k] - b.fits['full']['estimates'][k]) < 1e-9
    jp1, tp1 = JQPS(1, ['Gxpi2', 'Gypi2']), TQPS(1, ['Gxpi2', 'Gypi2'])
    jd, td = _design(jrb, jp1, 'interleaved', 5), _design(trb, tp1, 'interleaved', 5)
    jds, tds = JDataSet(), TDataSet()
    for key in ('crb', 'icrb'):
        j_, t_ = _same_counts(jd[key], td[key], 7 if key == 'crb' else 8)
        for jc, tc in zip(jd[key].all_circuits_needing_data, td[key].all_circuits_needing_data):
            jds.add_count_dict(jc, dict(j_[jc].counts))
            tds.add_count_dict(tc, dict(t_[tc].counts))
    a = jrb.InterleavedRandomizedBenchmarking(bootstrap_samples=0).run(JProtocolData(jd, jds))
    b = trb.InterleavedRandomizedBenchmarking(bootstrap_samples=0).run(TProtocolData(td, tds))
    for k in a.irb_numbers:
        assert abs(a.irb_numbers[k] - b.irb_numbers[k]) < 1e-9
        assert abs(a.irb_bounds[k] - b.irb_bounds[k]) < 1e-9


def test_rb_theory():
    """predicted_rb_number, the decay parameter, the RB gauge, the error
    maps and the R-matrix of a 1-qubit depolarized model: 1e-10."""
    jt, tt = jxy.target_model('full'), txy.target_model('full')
    jm = jt.depolarize(op_noise=0.02)
    tm = tt.depolarize(op_noise=0.02)
    for rtype in ('EI', 'AGI'):
        a = jth.predicted_rb_number(jm, jt, rtype=rtype)
        b = tth.predicted_rb_number(tm, tt, rtype=rtype)
        assert abs(a - b) < 1e-10 and 0 < b < 0.05
    w = {k: 1.0 + i for i, k in enumerate(tt.operations)}
    jw = {k: 1.0 + i for i, k in enumerate(jt.operations)}
    assert abs(jth.predicted_rb_decay_parameter(jm, jt, jw)
               - tth.predicted_rb_decay_parameter(tm, tt, w)) < 1e-10
    assert np.max(np.abs(np.asarray(jth.L_matrix(jm, jt)) - tth.L_matrix(tm, tt))) < 1e-12
    ja, ta = jth.errormaps(jm, jt), tth.errormaps(tm, tt)
    assert [str(k) for k in ja] == [str(k) for k in ta]
    assert all(np.max(np.abs(np.asarray(x) - y)) < 1e-12 for x, y in zip(ja.values(),
                                                                         ta.values()))
    assert np.max(np.abs(np.asarray(jth.rb_gauge(jm, jt)) - tth.rb_gauge(tm, tt))) < 1e-10
    tg = tth.transform_to_rb_gauge(tm, tt)
    assert abs(tth.predicted_rb_number(tg, tt) - tth.predicted_rb_number(tm, tt)) < 1e-9
    jg, tgrp = jgroup.construct_1q_clifford_group(), tgroup.construct_1q_clifford_group()
    assert len(tgrp) == 24 and all(np.array_equal(x, y) for x, y in zip(jg.mxs, tgrp.mxs))
    tmap = {tgrp.matrix_index(np.round(tt.operations[k].dense(), 9)): k for k in tt.operations}
    jmap = {jg.matrix_index(np.round(np.asarray(jt.operations[k].to_dense()), 9)): k
            for k in jt.operations}
    a = jth.R_matrix_predicted_rb_decay_parameter(jm, jg, jmap)
    b = tth.R_matrix_predicted_rb_decay_parameter(tm, tgrp, tmap)
    assert abs(a - b) < 1e-10


def test_rb_circuit_probabilities_on_a_crosstalk_free_model():
    """Success probabilities of direct- and Clifford-RB circuits on a
    depolarized 2-qubit crosstalk-free model: the port's (CPU) within 1e-10
    of the JAX package's; at strength 0 every ideal outcome has probability
    1."""
    jp, tp = specs(2)
    jd, td = _design(jrb, jp, 'direct', 1), _design(trb, tp, 'direct', 1)
    jc2, tc2 = _design(jrb, jp, 'clifford', 1), _design(trb, tp, 'clifford', 1)
    jcircs = list(jd.all_circuits_needing_data) + list(jc2.all_circuits_needing_data)
    tcircs = list(td.all_circuits_needing_data) + list(tc2.all_circuits_needing_data)
    ideals = [i for l in td.idealout_lists + tc2.idealout_lists for i in l]
    for strength in (0.0, 0.01):
        kw = dict(depolarization_strengths={g: strength for g in GATES})
        jm = jmc.create_crosstalk_free_model(jp, **kw)
        tm = tmc.create_crosstalk_free_model(tp, **kw)
        ja = jm.sim.bulk_probs(jcircs)
        ta = tm.bulk_probabilities(tcircs, device='cpu')
        for jc, tc, ideal in zip(jcircs, tcircs, ideals):
            assert max(abs(ja[jc][o] - ta[tc][o]) for o in ja[jc]) < 1e-10
            ps = ta[tc][(''.join(str(b) for b in ideal),)]
            if strength == 0:
                assert abs(ps - 1) < 1e-10
            else:
                assert 0.3 < ps < 1
        p = SimpleForwardSimulator(tm, 'cpu').bulk_fill_probs(
            None, SimpleForwardSimulator(tm, 'cpu').create_layout(tcircs))
        assert np.max(np.abs(p.reshape(len(tcircs), 4).sum(axis=1) - 1)) < 1e-12


def test_stabilizer_simulator():
    """Outcome distributions of random Clifford circuits equal the JAX
    package's, and each RB circuit's ideal outcome comes out with
    probability 1."""
    for n in (1, 2, 3):
        jp, tp = specs(n, GATES if n > 1 else ['Gxpi2', 'Gypi2'])
        js, ts = jstab.StabilizerForwardSimulator(jp), tstab.StabilizerForwardSimulator(tp)
        for seed in range(3):
            jc = jrc.create_random_circuit(jp, 5, rand_state=np.random.RandomState(seed))
            tc = trc.create_random_circuit(tp, 5, rand_state=np.random.RandomState(seed))
            a, b = js.probs(jc), ts.probs(tc)
            assert same(dict(a), dict(b))
            assert abs(sum(b.values()) - 1) < 1e-12
            keep = list(b)[:1]
            assert same(dict(js.probs(jc, keep)), dict(ts.probs(tc, keep)))
            c, ideal = trc.create_direct_rb_circuit(tp, None, 3,
                                                    rand_state=np.random.RandomState(seed))
            assert ts.probability(c, ideal) == js.probability(
                JCircuit(c.str), ideal) == 1.0
    sreps = tstab.StabilizerForwardSimulator(srep_dict={'Gfoo': (np.eye(2, dtype=int),
                                                                 np.zeros(2, int))})
    assert sreps.probability(TCircuit('Gfoo:0Gxpi2:0Gxpi2:0@(0)'), '1') == 1.0


class _SuccessModel(object):
    """A success/fail model: success decays with the circuit's depth."""

    def _success_prob(self, circuit):
        return 0.99 ** len(circuit)

    def probabilities(self, circuit, outcomes=None, time=None):
        from pygsti_tpu_torch.baseobjs.outcomelabeldict import OutcomeLabelDict
        p = self._success_prob(circuit)
        return OutcomeLabelDict([(('success',), p), (('fail',), 1 - p)])

    def _success_dprob(self, circuit, param_slice, cache):
        return np.array([-len(circuit) * 0.99 ** (len(circuit) - 1)])


def test_success_fail_simulator():
    """probs with and without clipping, dprobs and bulk_probs equal the JAX
    package's on the same model."""
    model = _SuccessModel()
    js, ts = jsf.SuccessFailForwardSimulator(model), tsf.SuccessFailForwardSimulator(model)
    circuits = [TCircuit('Gxpi2:0' * k + '@(0)') for k in (0, 1, 5, 40)]
    for c in circuits:
        for clip in (None, (0.7, 0.9)):
            assert same(dict(js.probs(c, clip_to=clip)), dict(ts.probs(c, clip_to=clip)))
        assert same(dict(js.dprobs(c)), dict(ts.dprobs(c)))
    assert same({str(k): dict(v) for k, v in js.bulk_probs(circuits).items()},
                {str(k): dict(v) for k, v in ts.bulk_probs(circuits).items()})


def test_rb_modules_import_no_jax():
    """The modules of this slice load, and an RB design runs and fits, in a
    process that ends with neither JAX nor pygsti_tpu imported."""
    import subprocess
    import sys
    new = ('tools.matrixmod2', 'tools.symplectic', 'tools.compilationtools', 'tools.rbtools',
           'tools.rbtheory', 'tools.group', 'algorithms.compilers', 'algorithms.mirroring',
           'algorithms.randomcircuit', 'algorithms.rbfit', 'protocols.rb',
           'forwardsims.stabilizersim', 'forwardsims.successfailsim',
           'processors.compilationrules')
    code = ("import sys, importlib\n"
            "for name in %r:\n"
            "    importlib.import_module('pygsti_tpu_torch.' + name)\n"
            "from pygsti_tpu_torch.processors.processorspec import QubitProcessorSpec\n"
            "from pygsti_tpu_torch.protocols.rb import DirectRBDesign\n"
            "d = DirectRBDesign(QubitProcessorSpec(2, ['Gxpi2', 'Gypi2', 'Gcnot'], "
            "geometry='line'), depths=[0, 2], circuits_per_depth=2, seed=1)\n"
            "assert len(d.all_circuits_needing_data) == 4\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'pygsti_tpu')]\n"
            "assert not bad, bad\n"
            "print('ok')\n" % (new,))
    out = subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                         capture_output=True, text=True).stdout
    assert out.strip().splitlines()[-1] == 'ok'
