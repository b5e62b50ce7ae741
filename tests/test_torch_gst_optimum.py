"""The 2-qubit fit of bench.py's workload in both packages on one dataset:
does the port reach the JAX package's optimum?

The dataset is drawn once with numpy from the JAX package's float64
probabilities (smq2Q_XYICNOT, maxL 1..64, the 'full TP' target
depolarized 0.01 / 0.01, 1000 shots, seed 1234), so both fits see the same
counts.  Both packages fit 'full' from the target on the CPU at float64,
chi2 stages then the Poisson-picture logL (MINCLIP 1e-4, as bench.py).
Marked slow: it is a full-size fit in each package.  ``run_both(maxl)``
runs the same comparison at a smaller maximum length.
"""

import time

import numpy as np
import pytest
import torch

MAXLENGTHS = (1, 2, 4, 8, 16, 32, 64)
MINCLIP = 1e-4


def _builders(mod):
    return mod.GSTObjFnBuilders(
        [mod.ObjectiveFunctionBuilder('chi2', regularization={
            'min_prob_clip_for_weighting': MINCLIP})],
        [mod.ObjectiveFunctionBuilder('logl', regularization={
            'min_prob_clip': MINCLIP, 'radius': MINCLIP})])


def run_both(maxl):
    """Both fits at maximum length `maxl`; returns a dict of the numbers
    compared and the seconds each package took."""
    import types
    import pygsti_tpu.modelpacks.smq2Q_XYICNOT as jmp
    from pygsti_tpu.circuits.gstcircuits import create_lsgst_circuit_lists as j_lists
    from pygsti_tpu.data import simulate_data as j_simulate
    from pygsti_tpu.objectivefns import objectivefns as jof
    from pygsti_tpu.protocols import gst as jgst
    from pygsti_tpu.protocols.protocol import ProtocolData as JData
    import pygsti_tpu_torch.modelpacks.smq2Q_XYICNOT as tmp
    from pygsti_tpu_torch.circuits.gstcircuits import create_lsgst_circuit_lists as t_lists
    from pygsti_tpu_torch.data.dataset import DataSet
    from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
    from pygsti_tpu_torch.objectivefns import objectivefns as tof
    from pygsti_tpu_torch.protocols import gst as tgst
    from pygsti_tpu_torch.protocols.protocol import ProtocolData as TData

    maxls = [L for L in MAXLENGTHS if L <= maxl]
    jt, tt = jmp.target_model('full'), tmp.target_model('full')
    jl = j_lists(jt, jmp.prep_fiducials(), jmp.meas_fiducials(), jmp.germs(), maxls)
    tl = t_lists(tt, tmp.prep_fiducials(), tmp.meas_fiducials(), tmp.germs(), maxls)
    jc, tc = list(jl[-1]), list(tl[-1])
    assert [c.str for c in tc] == [c.str for c in jc]
    jds = j_simulate(jmp.target_model('full TP').depolarize(op_noise=0.01, spam_noise=0.01),
                     jc, 1000, seed=1234)
    tds = DataSet()
    for a, b in zip(jc, tc):
        tds.add_count_dict(b, dict(jds[a].counts))

    jb = types.SimpleNamespace(GSTObjFnBuilders=jgst.GSTObjFnBuilders,
                               ObjectiveFunctionBuilder=jof.ObjectiveFunctionBuilder)
    tb = types.SimpleNamespace(GSTObjFnBuilders=tgst.GSTObjFnBuilders,
                               ObjectiveFunctionBuilder=tof.ObjectiveFunctionBuilder)
    t0 = time.time()
    jest = jgst.GateSetTomography(jgst.GSTInitialModel(model=jt.copy()), gaugeopt_suite=None,
                                  objfn_builders=_builders(jb), verbosity=0).run(
        JData(jgst.GateSetTomographyDesign(jt, jl), jds),
        disable_checkpointing=True).estimates['GateSetTomography']
    j_s = time.time() - t0
    t0 = time.time()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        test = tgst.GateSetTomography(tgst.GSTInitialModel(model=tt.copy()), gaugeopt_suite=None,
                                      objfn_builders=_builders(tb), verbosity=0,
                                      device='cpu').run(
            TData(tgst.GateSetTomographyDesign(tt, tl), tds),
            disable_checkpointing=True).estimates['GateSetTomography']
    finally:
        torch.set_num_threads(threads)
    t_s = time.time() - t0
    jm, tm = jest.models['final iteration estimate'], test.models['final iteration estimate']
    port_in_jax = jm.copy()
    port_in_jax.from_vector(tm.to_vector())
    j_val = jof.two_delta_logl(jm, jds, jc, min_prob_clip=MINCLIP)
    t_val = jof.two_delta_logl(port_in_jax, jds, jc, min_prob_clip=MINCLIP)
    jp = jm.sim.bulk_probs(jc)
    tp = SimpleForwardSimulator(tm, 'cpu').bulk_probs(tc)
    return {'circuits': len(jc), 'jax_2dlogl': j_val, 'port_2dlogl': t_val,
            'rel_2dlogl': abs(t_val - j_val) / j_val,
            'jax_nsigma': jest.misfit_sigma(), 'port_nsigma': test.misfit_sigma(),
            'max_dp': max(abs(jp[a][o] - tp[b][o]) for a, b in zip(jc, tc) for o in jp[a]),
            'jax_s': j_s, 'port_s': t_s}


@pytest.mark.slow
def test_port_reaches_the_jax_optimum_on_the_bench_workload():
    """2*DeltaLogL (both scored by the JAX package) within 1e-3 relative,
    N_sigma within 0.01 and per-circuit probabilities within 1e-4."""
    r = run_both(64)
    assert r['circuits'] == 13958
    assert r['rel_2dlogl'] < 1e-3, r
    assert abs(r['port_nsigma'] - r['jax_nsigma']) < 0.01, r
    assert r['max_dp'] < 1e-4, r
