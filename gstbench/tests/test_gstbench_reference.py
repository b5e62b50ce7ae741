"""The plain reference against the program on the CPU at small sizes:
smq1Q_XYI in 'full' on its maxL-2 design, and a 2-qubit cloud-noise 'H+s'
model, with and without 'H+S' SPAM, on random layers."""

import os

import numpy as np
import pytest
import torch

from gstbench import design, spec
from gstbench.check import element_order
from gstbench.reference.models import CloudNoise, FullGateSet
from gstbench.reference.objective import Problem
from gstbench.tests.checkout import FIXTURES

REGS = {'chi2': {'min_prob_clip_for_weighting': 1e-4},
        'logl': {'min_prob_clip': 1e-4, 'radius': 1e-4}}
CPU = torch.device('cpu')


def program_side(model, d, counts, outcomes, kind, theta):
    """(probabilities [N, M], value, gradient 2 J^T f) of the program."""
    from pygsti_tpu_torch.data.dataset import DataSet
    from pygsti_tpu_torch.objectivefns.objectivefns import ObjectiveFunctionBuilder
    circuits = design.port_circuits(d)
    ds = DataSet(outcome_labels=outcomes)
    for c, row in zip(circuits, counts.tolist()):
        ds.add_count_dict(c, dict(zip(outcomes, row)))
    model.from_vector(theta)
    obj = ObjectiveFunctionBuilder(kind, regularization=REGS[kind]).build(
        model, ds, circuits, device='cpu')
    ci, oi = element_order(obj.layout, outcomes)
    p = torch.zeros(counts.shape, dtype=torch.float64)
    p[ci, oi] = torch.as_tensor(obj.probs(theta))
    _, _, jtf = obj.jtj_jtf(theta)
    value = obj.fn(theta) * (2.0 if kind == 'logl' else 1.0)
    return p, value, 2.0 * torch.as_tensor(jtf)


def compare(ref, model, d, theta, kind, rng):
    n_out = ref.num_effects
    counts = rng.integers(0, 300, size=(len(d['circuits']), n_out)).astype(float)
    counts[0, 0] = 0.0                       # one zero count: the logl's zero-frequency terms
    problem = Problem(ref, d['layers'], design.seqs_array(d), counts, counts.sum(1), kind,
                      REGS[kind], torch.float64, CPU)
    p, value, g = program_side(model, d, counts, ref.outcomes, kind, theta)
    g_ref = problem.gradient(theta)
    assert float((p - problem.probs(theta)).abs().max()) < 1e-13
    assert value == pytest.approx(problem.value(theta), rel=1e-12)
    assert float((g - g_ref).abs().max()) <= 1e-10 * float(g_ref.abs().max())
    # the forward-mode Jacobian gives autograd's gradient
    _, J, dterms = problem.newton_decrement(theta)
    assert float((J.T @ dterms - g_ref).abs().max()) <= 1e-10 * float(g_ref.abs().max())


@pytest.fixture(scope='module')
def one_qubit():
    cfg = spec.load_json(os.path.join(FIXTURES, 'smq1q_xyi_full.json'))
    mod = spec.load_module(os.path.join(os.path.dirname(FIXTURES), '..', 'configs',
                                        'smq2q_xyicnot_full.py'), 'full_cfg')
    circuits, ends = mod.design_circuits(cfg, 'cpu')
    return cfg, mod, design.from_port_circuits(circuits, ends, 'test')


def test_full_gateset_matches_the_pack(one_qubit):
    cfg, mod, _ = one_qubit
    ref = FullGateSet(cfg)
    target = mod.start_model(cfg)
    assert ref.num_params == target.num_params == cfg['num_params']
    np.testing.assert_allclose(ref.theta_target().numpy(), target.to_vector(), atol=1e-15)
    t = cfg['truth']
    truth = target.depolarize(op_noise=t['depolarize_ops'], spam_noise=t['depolarize_spam'])
    np.testing.assert_allclose(mod.truth(cfg, ref).numpy(), truth.to_vector(), atol=1e-15)


@pytest.mark.parametrize('kind', ['chi2', 'logl'])
def test_full_gateset_against_the_program(one_qubit, kind):
    cfg, mod, d = one_qubit
    d = dict(d, depths=[len(c) for c in d['circuits']])
    ref = FullGateSet(cfg)
    rng = np.random.default_rng(3)
    theta = mod.truth(cfg, ref).numpy() + 1e-3 * rng.standard_normal(ref.num_params)
    compare(ref, mod.start_model(cfg), d, theta, kind, rng)


CLOUD2 = {'qubits': 2, 'edges': [[0, 1]], 'maxhops': 1, 'max_idle_weight': 1,
          'extra_gate_weight': 1, 'parameterization': 'H+s',
          'gates': [['Gxpi2', [[0], [1]]], ['Gypi2', [[0], [1]]], ['Gcnot', [[0, 1]]]]}


def random_cloud_design(rng, n=40, depth=6):
    layers = [[], [['Gxpi2', 0]], [['Gxpi2', 1]], [['Gypi2', 0]], [['Gypi2', 1]],
              [['Gcnot', 0, 1]], [['Gxpi2', 0], ['Gypi2', 1]], [['Gypi2', 0], ['Gxpi2', 1]]]
    circuits = []
    while len(circuits) < n:
        c = [int(x) for x in rng.integers(0, len(layers), size=rng.integers(0, depth + 1))]
        if c not in circuits:                # a dataset adds a repeated circuit's counts
            circuits.append(c)
    return {'layers': layers, 'circuits': circuits, 'line_labels': [0, 1], 'list_ends': [n],
            'depths': [len(c) for c in circuits]}


@pytest.mark.parametrize('spam, num_params', [('computational', 162), ('H+S', 186)])
@pytest.mark.parametrize('kind', ['chi2', 'logl'])
def test_cloud_noise_against_the_program(kind, spam, num_params):
    from pygsti_tpu_torch.models.cloudnoisemodel import \
        create_cloud_crosstalk_model_from_hops_and_weights
    from pygsti_tpu_torch.processors.processorspec import QubitProcessorSpec
    rng = np.random.default_rng(5)
    ref = CloudNoise(dict(CLOUD2, spam_type=spam, max_spam_weight=1))
    model = create_cloud_crosstalk_model_from_hops_and_weights(
        QubitProcessorSpec(2, ['Gxpi2', 'Gypi2', 'Gcnot'], geometry='line'), maxhops=1,
        max_idle_weight=1, extra_gate_weight=1, gate_type='H+s', spam_type=spam,
        max_spam_weight=1)
    assert ref.num_params == model.num_params == num_params
    theta = 0.01 * rng.standard_normal(ref.num_params)
    compare(ref, model, random_cloud_design(rng), theta, kind, rng)


def test_cloud_truth_plants_its_rate():
    cfg = spec.load_json(os.path.join(os.path.dirname(FIXTURES), '..', 'configs',
                                      'cloud3q_line_hs.json'))
    ref = CloudNoise(cfg)
    assert ref.num_params == cfg['num_params']
    v = spec.load_module(os.path.join(os.path.dirname(FIXTURES), '..', 'configs',
                                      'cloud3q_line_hs.py'), 'cloud_cfg').truth(cfg, ref)
    # the prep's and the POVM's 18 parameters each come before the idle's
    assert v[ref.param_index('idle', 'H', 'XII')] == 0.03 and ref.param_index('idle', 'H', 'XII') == 42
    expect = 0.002 * np.abs(np.random.RandomState(16).randn(570))
    keep = np.arange(570) != 42
    np.testing.assert_array_equal(v.numpy()[keep], expect[keep])
