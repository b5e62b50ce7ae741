"""The port's extras/lfh against the JAX package's: the integrating, weak
and sigma-point fluctuating-Hamiltonian simulators on the same models and
fluctuations (probabilities within 1e-10; the weak simulator with the same
base_seed draws the same offsets), the port's one-layout evaluation in
batches of any size, the cases of tests/test_lfh.py, and the
LFHLindbladErrorgen / LFHExplicitOpModel surface."""

import numpy as np
import pytest
import torch

from pygsti_tpu.extras import lfh as jl
from pygsti_tpu.extras.lfh.lfherrorgen import LFHLindbladErrorgen as JErrgen
from pygsti_tpu.modelpacks import smq1Q_XYI as jmp1, smq2Q_XYICNOT as jmp2
from pygsti_tpu.circuits import Circuit as JCircuit

from pygsti_tpu_torch.extras import lfh as tl
from pygsti_tpu_torch.extras.lfh import lfh as tl_mod
from pygsti_tpu_torch.extras.lfh.lfherrorgen import LFHLindbladErrorgen as TErrgen
from pygsti_tpu_torch.extras.lfh.lfhmodel import LFHExplicitOpModel
from pygsti_tpu_torch.modelpacks import smq1Q_XYI as tmp1, smq2Q_XYICNOT as tmp2
from pygsti_tpu_torch.circuits import Circuit
from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
from pygsti_tpu_torch.modelmembers.operations import StaticArbitraryOp

SIMS = [('LFHIntegratingForwardSimulator', dict(order=5)),
        ('LFHWeakForwardSimulator', dict(shots=40, base_seed=3)),
        ('LFHSigmaForwardSimulator', {})]
C1 = ['Gxpi2:0Gypi2:0Gypi2:0Gxpi2:0Gxpi2:0Gxpi2:0Gxpi2:0Gxpi2:0@(0)', 'Gypi2:0Gxpi2:0@(0)']
C2 = ['Gxpi2:0Gcnot:0:1Gypi2:1@(0,1)', 'Gypi2:1Gypi2:1Gxpi2:0Gxpi2:0@(0,1)']


def _models(jmp, tmp, seed):
    """The pack's 'H+s' target moved by seeded rates, in both packages."""
    j, t = jmp.target_model('H+s'), tmp.target_model('H+s')
    v = np.asarray(j.to_vector()) + np.random.RandomState(seed).randn(j.num_params) * 0.01
    j.from_vector(v)
    t.from_vector(v)
    return j, t


@pytest.fixture(scope='module')
def models1():
    j, t = _models(jmp1, tmp1, 0)
    i0 = t.operations[list(t.operations.keys())[1]].gpindices.start
    return j, t, {i0: 0.05, i0 + 2: 0.03}


@pytest.mark.parametrize("name,kw", SIMS)
def test_simulators_match_jax_1q(models1, name, kw):
    j, t, devs = models1
    js = getattr(jl, name)(j, jl.GaussianParamFluctuation(devs), **kw)
    ts = getattr(tl, name)(t, tl.GaussianParamFluctuation(devs), device='cpu', **kw)
    tp = ts.bulk_probs([Circuit(s) for s in C1])
    # the JAX package compiles each circuit's simulator; the sigma-point's
    # nested jacfwd is held on the first circuit only
    for s in (C1[:1] if name == 'LFHSigmaForwardSimulator' else C1):
        jp = js.probs(JCircuit(s))
        assert max(abs(jp[o] - tp[Circuit(s)][o]) for o in jp) < 1e-10
    one = ts.probs(Circuit(C1[0]), clip_to=(0.0, 0.9))
    assert max(one.values()) <= 0.9


@pytest.mark.parametrize("name,kw", SIMS[:2])
def test_simulators_match_jax_2q(name, kw):
    """At two qubits (the sigma-point simulator is held at one: the JAX
    package compiles its nested jacfwd per circuit)."""
    j, t = _models(jmp2, tmp2, 1)
    ops = list(t.operations.keys())
    t._rebuild_paramvec_if_needed()
    devs = {t.operations[ops[3]].gpindices.start: 0.02,
            t.operations[ops[2]].gpindices.start + 1: 0.01}
    js = getattr(jl, name)(j, jl.GaussianParamFluctuation(devs), **kw)
    tp = getattr(tl, name)(t, tl.GaussianParamFluctuation(devs), device='cpu',
                           **kw).bulk_probs([Circuit(s) for s in C2])
    for s in C2:
        jp = js.probs(JCircuit(s))
        assert max(abs(jp[o] - tp[Circuit(s)][o]) for o in jp) < 1e-10


def test_batches_of_any_size(models1, monkeypatch):
    """The grid in batches of one point gives what one batch gives."""
    _, t, devs = models1
    sim = tl.LFHWeakForwardSimulator(t, tl.GaussianParamFluctuation(devs), shots=7,
                                     base_seed=2, device='cpu')
    whole, _ = sim.bulk_fill_probs([Circuit(s) for s in C1])
    monkeypatch.setattr(tl_mod, 'BATCH_BYTES', 1)
    ones, _ = sim.bulk_fill_probs([Circuit(s) for s in C1])
    assert float((whole - ones).abs().max()) < 1e-15
    np.testing.assert_array_equal(sim.offsets(), np.random.RandomState(2).randn(7, 2)
                                  * np.array([0.05, 0.03]))


@pytest.fixture(scope='module')
def setup():
    """tests/test_lfh.py's setup: smq1Q_XYI 'H+s', one rate fluctuating."""
    m = tmp1.target_model('H+s')
    m._rebuild_paramvec_if_needed()
    i0 = m.operations[list(m.operations.keys())[1]].gpindices.start
    return m, tl.GaussianParamFluctuation({i0: 0.05}), Circuit([('Gxpi2', 0)] * 8, (0,))


def test_integrating_vs_monte_carlo(setup):
    m, fl, c = setup
    pi = tl.LFHIntegratingForwardSimulator(m, fl, order=9, device='cpu').probs(c)
    pw = tl.LFHWeakForwardSimulator(m, fl, shots=20000, base_seed=0, device='cpu').probs(c)
    for o in pi:
        assert abs(pi[o] - pw[o]) < 0.01


def test_sigma_second_order_and_dephasing(setup):
    m, fl, c = setup
    pi = tl.LFHIntegratingForwardSimulator(m, fl, order=9, device='cpu').probs(c)
    ps = tl.LFHSigmaForwardSimulator(m, fl, device='cpu').probs(c)
    p0 = SimpleForwardSimulator(m, 'cpu').probs(c)
    for o in pi:
        assert abs(pi[o] - ps[o]) < 0.02
    assert abs(pi[('0',)] - p0[('0',)]) > 0.001
    assert abs(sum(pi.values()) - 1.0) < 1e-12


def test_zero_dev_recovers_exact(setup):
    m, fl, c = setup
    fl0 = tl.GaussianParamFluctuation({list(fl.param_devs)[0]: 0.0})
    p0 = SimpleForwardSimulator(m, 'cpu').probs(c)
    for name, kw in SIMS:
        p = getattr(tl, name)(m, fl0, device='cpu', **kw).probs(c)
        assert max(abs(p[o] - p0[o]) for o in p0) < 1e-12


def test_lfh_errorgen_matches_jax():
    kw = dict(h_means=[0.01, 0.0, 0.02], otherlindbladparams=np.arange(9) * 1e-3,
              h_devs={'X': 0.005, 'Y': 0.004, 'Z': 0.003})
    j, t = JErrgen(rng=7, **kw), TErrgen(rng=7, **kw)
    assert t.num_params == j.num_params == 12
    np.testing.assert_allclose(t.to_dense(), j.to_dense(), rtol=0, atol=1e-15)
    for _ in range(3):
        np.testing.assert_array_equal(t.sample_hamiltonian_rates(), j.sample_hamiltonian_rates())
        np.testing.assert_allclose(t.to_dense(), j.to_dense(), rtol=0, atol=1e-15)
    assert list(t.coefficients) == list(j.coefficients)
    v = np.linspace(-0.01, 0.01, 12)
    t.from_vector(v)
    j.from_vector(v)
    np.testing.assert_array_equal(t.to_vector(), j.to_vector())
    np.testing.assert_allclose(t.to_dense(), j.to_dense(), rtol=0, atol=1e-15)
    h = TErrgen([0, 0, 0.5], np.zeros(9), [0, 0, 0]).to_dense()
    assert abs(h[0, 0]) < 1e-12 and abs(abs(h[1, 2]) - 1.0) < 1e-9


def test_lfh_model_samples_its_errorgens():
    model = LFHExplicitOpModel(4)
    for k, seed in enumerate((3, 4)):
        member = StaticArbitraryOp(np.eye(4))
        member.errorgen = TErrgen([0.01, 0.0, 0.02], np.zeros(9), [0.1, 0.1, 0.1], rng=seed)
        model.operations['G%d' % k] = member
    model.sample_hamiltonian_rates()
    for k, seed in enumerate((3, 4)):
        ref = JErrgen([0.01, 0.0, 0.02], np.zeros(9), [0.1, 0.1, 0.1], rng=seed)
        np.testing.assert_array_equal(model.operations['G%d' % k].errorgen.current_rates[:3],
                                      ref.sample_hamiltonian_rates())
