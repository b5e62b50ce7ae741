"""Mirror-circuit benchmarks with their data simulated on a card against
the CPU path: a 3-qubit MCFE run and a periodic-mirror VB design.

Imports nothing of JAX, so it also runs on a machine without JAX:
    python -m pytest tests/test_torch_mirror_cuda.py --noconftest -q
Without a card the tests skip.
"""

import numpy as np
import pytest
import torch

from pygsti_tpu_torch.baseobjs.label import Label
from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.data.datasetconstruction import simulate_data
from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
from pygsti_tpu_torch.models.modelconstruction import create_crosstalk_free_model
from pygsti_tpu_torch.processors.processorspec import QubitProcessorSpec
from pygsti_tpu_torch.processors.random_compilation import u3_unitary
from pygsti_tpu_torch.protocols.mirror_edesign import haar_random_u3
from pygsti_tpu_torch.protocols.protocol import ProtocolData
from pygsti_tpu_torch.protocols.scarab import calculate_mirror_benchmark_results, mirror_benchmark
from pygsti_tpu_torch.protocols.vb import ByDepthSummaryStatistics, PeriodicMirrorCircuitDesign


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def u3f(args):
    return u3_unitary(*(float(a) for a in args))


@pytest.mark.cuda
def test_mcfe_on_the_card_against_the_cpu(card):
    """The probabilities of 3-qubit mirror circuits card against CPU
    (1e-10), and the MCFE results from the same counts equal."""
    pspec = QubitProcessorSpec(3, ['Gu3', 'Gcnot'], geometry='line',
                               nonstd_gate_unitaries={'Gu3': u3f})
    mdl = create_crosstalk_free_model(pspec, depolarization_strengths={'Gu3': 0.003, 'Gcnot': 0.02})
    rng = np.random.RandomState(7)
    test = Circuit([[haar_random_u3(q, rng) for q in range(3)], [Label('Gcnot', (0, 1))],
                    [haar_random_u3(q, rng) for q in range(3)], [Label('Gcnot', (1, 2))]], (0, 1, 2))
    design = mirror_benchmark([test], num_mcs_per_circ=4, rand_state=np.random.RandomState(0))
    circuits = design.all_circuits_needing_data
    a = SimpleForwardSimulator(mdl, 'cuda')
    b = SimpleForwardSimulator(mdl, 'cpu')
    pa = a.bulk_fill_probs(a.create_layout(circuits))
    pb = b.bulk_fill_probs(b.create_layout(circuits))
    assert np.abs(pa - pb).max() < 1e-10
    ds = simulate_data(mdl, circuits, 1000, seed=3, device='cuda')
    res = calculate_mirror_benchmark_results([test], ProtocolData(design, ds), num_bootstraps=10,
                                             rand_state=np.random.RandomState(1))
    assert 0.8 < res.table['process_fidelity'][0] <= 1.0


@pytest.mark.cuda
def test_vb_on_the_card_against_the_cpu(card):
    """Periodic mirror circuits at width 2: card against CPU (1e-10); the
    ideal outcome's probability under the noiseless model is 1 (1e-10)."""
    gates = ['Gxpi2', 'Gypi2', 'Gxpi', 'Gzpi', 'Gypi', 'Gcnot']
    pspec = QubitProcessorSpec(2, gates, geometry='line')
    germ = Circuit([[('Gxpi2', 0), ('Gypi2', 1)], [('Gcnot', 0, 1)]], (0, 1))
    design = PeriodicMirrorCircuitDesign(pspec, [0, 4, 8], 4, germ, seed=4)
    circuits = design.all_circuits_needing_data
    mdl = create_crosstalk_free_model(pspec, depolarization_strengths={g: 0.01 for g in gates})
    ideal = create_crosstalk_free_model(pspec, depolarization_strengths={g: 0.0 for g in gates})
    a, b = SimpleForwardSimulator(mdl, 'cuda'), SimpleForwardSimulator(mdl, 'cpu')
    assert np.abs(a.bulk_fill_probs(a.create_layout(circuits))
                  - b.bulk_fill_probs(b.create_layout(circuits))).max() < 1e-10
    probs = SimpleForwardSimulator(ideal, 'cuda').bulk_probs(circuits)
    ideals = [i for l in design.idealout_lists for i in l]
    for c, i in zip(circuits, ideals):
        assert abs(probs[c][(''.join(map(str, i)),)] - 1.0) < 1e-10
    ds = simulate_data(mdl, circuits, 1000, seed=2, device='cuda')
    res = ByDepthSummaryStatistics().run(ProtocolData(design, ds))
    assert sorted(res.statistics['polarization'].keys()) == [0, 4, 8]
