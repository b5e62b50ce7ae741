"""The cloud-noise design's amplification analysis on a card against the
CPU path: one 3-qubit germ's candidate fiducial pairs, their amplification
matrices and the pairs the rank selection keeps.

Imports nothing of JAX, so it also runs on a machine without JAX:
    python -m pytest tests/test_torch_cloudnoise_designs_cuda.py --noconftest -q
Without a card the tests skip.
"""

import itertools

import numpy as np
import pytest
import torch

from pygsti_tpu_torch.baseobjs.label import Label
from pygsti_tpu_torch.circuits import cloudcircuitconstruction as ccc
from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.models.cloudnoisemodel import \
    create_cloud_crosstalk_model_from_hops_and_weights
from pygsti_tpu_torch.processors.processorspec import QubitProcessorSpec

FIDS = [(), ('Gxpi2',), ('Gypi2',), ('Gxpi2', 'Gxpi2')]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_amplification_and_chosen_pairs_match_the_cpu(card):
    """Gcnot:1:2 of the 3-qubit cloud model of chip_smoke.py's phase 20
    (maxhops 1, extra gate weight 1, 534 parameters), 64 seeded candidate
    pairs: the amplification matrices on the card within 1e-12 of the
    CPU's, the same pairs chosen, the bases orthonormal."""
    spec = QubitProcessorSpec(3, ['Gxpi2', 'Gypi2', 'Gcnot'], geometry='line')
    model = create_cloud_crosstalk_model_from_hops_and_weights(
        spec, max_idle_weight=1, maxhops=1, extra_gate_weight=1, gate_type='H+s')
    q = (0, 1, 2)
    pairs = list(itertools.product(itertools.product(FIDS, repeat=3), repeat=2))
    sel = sorted(np.random.RandomState(0).choice(len(pairs), size=64, replace=False))
    fidpairs = [(ccc._fiducial_circuit(pairs[i][0], q, q),
                 ccc._fiducial_circuit(pairs[i][1], q, q)) for i in sel]
    germ = Circuit((Label('Gcnot', (1, 2)),), line_labels=q)
    card_mats = ccc._amped_matrices(model, germ, 1, fidpairs, 'cuda')
    cpu_mats = ccc._amped_matrices(model, germ, 1, fidpairs, 'cpu')
    assert max(float(np.max(np.abs(a - b))) for a, b in zip(card_mats, cpu_mats)) < 1e-12
    chosen_card, Q_card = ccc._greedy_rank_select(card_mats, None)
    chosen_cpu, Q_cpu = ccc._greedy_rank_select(cpu_mats, None)
    assert chosen_card == chosen_cpu and Q_card.shape == Q_cpu.shape
    assert Q_card.shape[0] <= model.num_params
    assert np.max(np.abs(Q_card @ Q_card.T - np.eye(Q_card.shape[0]))) < 1e-13
