"""The time-resolved objective and the batched drift spectra on a card
against their CPU paths.

Imports nothing of JAX, so it also runs on a machine without JAX:
    python -m pytest tests/test_torch_timedep_cuda.py --noconftest -q
Without a card the tests skip.
"""

import numpy as np
import pytest
import torch

from pygsti_tpu_torch.baseobjs.label import Label
from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.circuits.gstcircuits import create_lsgst_circuit_lists
from pygsti_tpu_torch.data.dataset import DataSet
from pygsti_tpu_torch.extras.drift import signal
from pygsti_tpu_torch.extras.drift.stabilityanalyzer import StabilityAnalyzer
from pygsti_tpu_torch.modelmembers import operations as ops
from pygsti_tpu_torch.modelpacks import smq2Q_XYICNOT as mp
from pygsti_tpu_torch.objectivefns.timedep import TimeDependentPoissonPicLogLFunction


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _rel(a, b):
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


@pytest.mark.cuda
def test_timedep_jtj_jtf_card_against_cpu(card):
    """A 2-qubit 'full TP' model whose Gxpi2:0 drifts (15 H rates), maxL
    1..4 circuits at 5 times, one circuit without data at one time: lsvec,
    J^T J and J^T f within 1e-12 relative of the CPU path."""
    model = mp.target_model('full TP')
    key = Label('Gxpi2', 0)
    model.operations[key] = ops.LinearTimeDriftOp(
        ops.FullTPOp(model.operations[key].dense()), ops.build_lindblad_errorgen('pp', 'H', dim=16))
    circuits = list(create_lsgst_circuit_lists(mp.target_model('full'), mp.prep_fiducials(),
                                               mp.meas_fiducials(), mp.germs(), [1, 2, 4])[-1])
    rng = np.random.RandomState(4)
    outcomes = [('00',), ('01',), ('10',), ('11',)]
    ds = DataSet()
    for i, c in enumerate(circuits):
        times = [t for t in range(5) if not (i == 3 and t == 2)]
        ols, ts, reps = [], [], []
        for t in times:
            for o, n in zip(outcomes, rng.multinomial(100, rng.dirichlet(np.ones(4)))):
                ols.append(o)
                ts.append(float(t))
                reps.append(int(n))
        ds.add_raw_series_data(c, ols, ts, reps)
    v = model.to_vector() + 0.003 * rng.randn(model.num_params)
    out = [TimeDependentPoissonPicLogLFunction(model, ds, circuits, device=dev).jtj_jtf(v)
           for dev in ('cuda', 'cpu')]
    for a, b in zip(*out):
        assert _rel(a, b) < 1e-12


@pytest.mark.cuda
def test_drift_spectra_card_against_cpu(card):
    """dct_power_spectra and lsp_power_spectra on the card, and an
    analyzer's base spectra, within 1e-12 of the CPU path."""
    rng = np.random.RandomState(9)
    x = (rng.rand(40, 3, 1000) < 0.3).astype(float)
    a, b = (signal.dct_power_spectra(x, dev).cpu().numpy() for dev in ('cuda', 'cpu'))
    assert np.max(np.abs(a - b)) < 1e-12
    times = np.cumsum(0.5 + rng.rand(20, 300), axis=1)
    freqs = np.stack([signal.frequencies_from_timestep((t[-1] - t[0]) / 299, 300)[1:]
                      for t in times])
    a, b = (signal.lsp_power_spectra(x[:20, 0, :300], times, freqs, dev).cpu().numpy()
            for dev in ('cuda', 'cpu'))
    assert np.max(np.abs(a - b)) < 1e-12 * max(1.0, np.abs(b).max())
    ds = DataSet()
    for i in range(6):
        bits = rng.rand(500) < 0.5 + 0.2 * np.cos(np.pi * 5 * (np.arange(500) + 0.5) / 500) * (i == 0)
        ds.add_raw_series_data(Circuit([('Gxpi2', 0)] * (i + 1), (0,)),
                               [('1',) if q else ('0',) for q in bits],
                               np.arange(500.0))
    spectra = []
    for dev in ('cuda', 'cpu'):
        an = StabilityAnalyzer(ds, device=dev)
        an.compute_spectra()
        an.run_instability_detection()
        spectra.append(an._basespectra)
    assert np.max(np.abs(spectra[0] - spectra[1])) < 1e-12

