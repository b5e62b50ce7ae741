"""Sparse outcomes, the forward-mode Jacobian and instruments of
pygsti_tpu_torch on a card against the CPU path.

Imports nothing of JAX, so it also runs on a machine without JAX:
    python -m pytest tests/test_torch_sparse_cuda.py --noconftest -q
(``--noconftest`` skips tests/conftest.py, which imports JAX).  Without a
card the tests skip.
"""

import numpy as np
import pytest
import torch

import pygsti_tpu_torch.modelpacks.smq2Q_XYICNOT as mp
from pygsti_tpu_torch.baseobjs.label import Label
from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.circuits.gstcircuits import create_lsgst_circuit_lists
from pygsti_tpu_torch.data.datasetconstruction import simulate_data
from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
from pygsti_tpu_torch.modelmembers.instruments import TPInstrument
from pygsti_tpu_torch.objectivefns.objectivefns import ObjectiveFunctionBuilder
from pygsti_tpu_torch.ops.bwd_jacobian import bwd_jacobian_accumulate
from pygsti_tpu_torch.tools.basistools import change_basis


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _with_instrument(model):
    """`model` with a TPInstrument 'Iz:0': a Z measurement of qubit 0."""
    members = {}
    for k in (0, 1):
        P = np.kron(np.diag([1.0 - k, float(k)]), np.eye(2))
        members['p%d' % k] = np.real(change_basis(np.kron(P, P.conj()), 'std', 'pp'))
    model.instruments[Label('Iz', 0)] = TPInstrument(members)
    return model


def _design(maxlengths, stride):
    target = mp.target_model('full TP')
    circuits = list(create_lsgst_circuit_lists(target, mp.prep_fiducials(), mp.meas_fiducials(),
                                               mp.germs(), maxlengths)[-1])[::stride]
    return target, circuits


@pytest.mark.cuda
@pytest.mark.parametrize("objective", ['logl', 'chi2'])
def test_forward_mode_on_a_sparse_layout_matches_the_cpu(card, objective):
    """The sparse objective ('linearize': forward-mode tangents with the
    omitted-probability correction) of a small 2-qubit design with 40
    shots, on the card and on the CPU: fn, lsvec, J^T J, J^T f and dlsvec
    within 1e-9 relative."""
    target, circuits = _design([1, 2], 16)
    gen = target.depolarize(op_noise=0.02, spam_noise=0.01)
    ds = simulate_data(gen, circuits, 40, seed=7, device='cpu')
    theta = gen.to_vector() + 1e-2 * np.random.RandomState(1).randn(gen.num_params)
    objs = []
    for dev in ('cuda', 'cpu'):
        lay = SimpleForwardSimulator(target, dev).create_layout(circuits, ds,
                                                                observed_outcomes_only=True)
        objs.append(ObjectiveFunctionBuilder(objective).build(target, ds, circuits,
                                                              device=dev, layout=lay))
    card_obj, cpu_obj = objs
    assert card_obj.layout.has_omitted and card_obj.jac_mode == 'linearize'
    assert np.isclose(card_obj.fn(theta), cpu_obj.fn(theta), rtol=1e-9, atol=0)
    for a, b in zip(card_obj.jtj_jtf(theta) + (card_obj.dlsvec(theta),),
                    cpu_obj.jtj_jtf(theta) + (cpu_obj.dlsvec(theta),)):
        assert a.shape == b.shape and _rel(a, b) < 1e-9


@pytest.mark.cuda
def test_instrument_layout_on_the_card_matches_the_cpu(card):
    """Probabilities of instrument circuits (one and two mid-circuit
    measurements) on the card within 1e-10 of the CPU's, and the blocked
    J^T J / J^T f of the instrument layout, which launches the kernel at
    K1 = 9, within 1e-9 relative."""
    model = _with_instrument(mp.target_model('full TP').depolarize(op_noise=0.02,
                                                                   spam_noise=0.01))
    iz = Circuit([Label('Iz', 0)], line_labels=(0, 1))
    circuits = [p + iz * k + m for k in (1, 2) for p in mp.prep_fiducials()[::3]
                for m in mp.meas_fiducials()[::2]] + list(mp.germs()[:8])
    probs = [SimpleForwardSimulator(model, dev).bulk_fill_probs(None,
        SimpleForwardSimulator(model, dev).create_layout(circuits)) for dev in ('cuda', 'cpu')]
    assert probs[0].shape == probs[1].shape
    assert np.max(np.abs(probs[0] - probs[1])) < 1e-10
    ds = simulate_data(model, circuits, 1000, seed=3, device='cpu')
    theta = model.to_vector() + 1e-3 * np.random.RandomState(2).randn(model.num_params)
    before = bwd_jacobian_accumulate.launches
    card_obj, cpu_obj = (ObjectiveFunctionBuilder('logl').build(model, ds, circuits, device=dev)
                         for dev in ('cuda', 'cpu'))
    card_out = card_obj.jtj_jtf(theta)
    assert card_obj.jac_mode == 'blocked' and bwd_jacobian_accumulate.launches > before
    for a, b in zip(card_out, cpu_obj.jtj_jtf(theta)):
        assert a.shape == b.shape and _rel(a, b) < 1e-9
