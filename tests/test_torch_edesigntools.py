"""Experiment-design tools of the port against the JAX package on the CPU:
the Fisher information (per circuit, summed, by L; approximate and exact)
within 1e-9 relative to the largest entry, the run-time estimate and the
idle-padded design exactly."""

import numpy as np
import pytest
import torch

import pygsti_tpu.modelpacks.smq1Q_XYI as jmp
from pygsti_tpu.circuits.gstcircuits import create_lsgst_circuit_lists as j_lists
from pygsti_tpu.protocols.protocol import ExperimentDesign as JDesign
from pygsti_tpu.tools import edesigntools as jed

import pygsti_tpu_torch.modelpacks.smq1Q_XYI as tmp
from pygsti_tpu_torch.circuits.gstcircuits import create_lsgst_circuit_lists as t_lists
from pygsti_tpu_torch.protocols.protocol import CircuitListsDesign, ExperimentDesign
from pygsti_tpu_torch.tools import edesigntools as ted


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """torch on one thread in this module, beside the other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.fixture(scope='module')
def design():
    jm, tm = jmp.target_model('full'), tmp.target_model('full')
    theta = jm.to_vector() + 0.02 * np.random.RandomState(4).randn(jm.num_params)
    jm.from_vector(theta)
    tm.from_vector(theta)
    jl = j_lists(jm, jmp.prep_fiducials(), jmp.meas_fiducials(), jmp.germs(), [1, 2])
    tl = t_lists(tm, tmp.prep_fiducials(), tmp.meas_fiducials(), tmp.germs(), [1, 2])
    return jm, tm, jl, tl


@pytest.mark.parametrize("approx", [True, False])
def test_fisher_information(design, approx):
    jm, tm, jl, tl = design
    jc, tc = list(jl[-1])[::8], list(tl[-1])[::8]   # the JAX package jits per circuit
    shots_j = {c: 100 + 7 * i for i, c in enumerate(jc)}
    shots_t = {c: 100 + 7 * i for i, c in enumerate(tc)}
    Fj = jed.calculate_fisher_information_matrix(jm, jc, shots_j, approx=approx)
    Ft = ted.calculate_fisher_information_matrix(tm, tc, shots_t, approx=approx, device='cpu')
    assert _rel(Ft, Fj) < 1e-9
    pj = jed.calculate_fisher_information_per_circuit(jm, jc[:6], approx=approx)
    pt = ted.calculate_fisher_information_per_circuit(tm, tc[:6], approx=approx, device='cpu')
    for a, b in zip(jc[:6], tc[:6]):
        assert _rel(pt[b], pj[a]) < 1e-9
    # the sum of the per-circuit matrices, and a cache that holds them
    assert _rel(ted.calculate_fisher_information_matrix(tm, tc[:6], 3, term_cache=pt,
                                                        device='cpu'),
                3 * sum(pj[a] for a in jc[:6])) < 1e-9


@pytest.mark.parametrize("cumulative", [True, False])
def test_fisher_information_by_L(design, cumulative):
    jm, tm, jl, tl = design
    # nested lists of a few circuits each: the JAX package jits per circuit
    jl = [list(jl[0])[:5], list(jl[0])[:5] + list(jl[1])[-5:]]
    tl = [list(tl[0])[:5], list(tl[0])[:5] + list(tl[1])[-5:]]
    bj = jed.calculate_fisher_information_matrices_by_L(jm, jl, [1, 2], num_shots=50,
                                                        cumulative=cumulative)
    bt = ted.calculate_fisher_information_matrices_by_L(tm, tl, [1, 2], num_shots=50,
                                                        cumulative=cumulative, device='cpu')
    assert list(bt) == list(bj)
    for L in bj:
        assert _rel(bt[L], bj[L]) < 1e-9
    if cumulative:
        assert np.linalg.eigvalsh(bt[2] - bt[1]).min() > -1e-10 * np.max(np.abs(bt[2]))


def test_runtime_and_padding(design):
    _, _, jl, tl = design
    jd, td = JDesign(list(jl[-1]), (0,)), ExperimentDesign(list(tl[-1]), (0,))
    for kw in (dict(gate_time_1Q=50e-9, gate_time_2Q=200e-9, measure_reset_time=1e-6),
               dict(gate_time_1Q=50e-9, gate_time_2Q=200e-9, measure_reset_time=1e-6,
                    circuits_per_batch=7, interbatch_latency=0.1,
                    shots_per_circuit_per_batch=300)):
        assert ted.calculate_edesign_estimated_runtime(td, **kw) == \
            jed.calculate_edesign_estimated_runtime(jd, **kw)
    jp = jed.pad_edesign_with_idle_lines(jd, (0, 1))
    tp = ted.pad_edesign_with_idle_lines(td, (0, 1))
    assert [c.str for c in tp.all_circuits_needing_data] == \
        [c.str for c in jp.all_circuits_needing_data]
    assert all(c.line_labels == (0, 1) for c in tp.all_circuits_needing_data)
    lists = ted.pad_edesign_with_idle_lines(CircuitListsDesign([list(l) for l in tl]), (0, 2))
    assert [len(l) for l in lists.circuit_lists] == [len(l) for l in tl]
