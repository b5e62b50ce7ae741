"""The port's 21 GST model packs against the JAX package's: operation order,
dense targets, germs and fiducials, fiducial-pair-reduction data, Clifford
compilations and the experiment designs with every option of the circuit
construction."""

import importlib

import numpy as np
import pytest

from pygsti_tpu.circuits.gstcircuits import create_lsgst_circuit_lists as j_lists

from pygsti_tpu_torch.circuits.gstcircuits import create_lsgst_circuit_lists as t_lists

PACKS = ['smq1Q_XY', 'smq1Q_XYI', 'smq1Q_XYZI', 'smq1Q_XZ', 'smq1Q_ZN', 'smq1Q_pi4_pi2_XZ',
         'smq2Q_XXII', 'smq2Q_XXII_condensed', 'smq2Q_XXYYII', 'smq2Q_XXYYII_condensed',
         'smq2Q_XY', 'smq2Q_XYCNOT', 'smq2Q_XYCPHASE', 'smq2Q_XYI', 'smq2Q_XYI1', 'smq2Q_XYI2',
         'smq2Q_XYICNOT', 'smq2Q_XYICPHASE', 'smq2Q_XYXX', 'smq2Q_XYZICNOT', 'smq2Q_XYZZ']
ONE_QUBIT = [p for p in PACKS if p.startswith('smq1Q')]


def packs(name):
    return (importlib.import_module('pygsti_tpu.modelpacks.' + name),
            importlib.import_module('pygsti_tpu_torch.modelpacks.' + name))


def strs(circuits):
    return [c.str for c in circuits]


def same_lists(jlists, tlists):
    assert [strs(l) for l in jlists] == [strs(l) for l in tlists]


def test_every_gst_pack_of_the_jax_package_is_ported():
    """Every smq pack of the JAX package but the two RPE packs (held in
    tests/test_torch_rpe.py) is in the list above."""
    import os
    import pygsti_tpu.modelpacks as jpk
    names = sorted(f[:-3] for f in os.listdir(os.path.dirname(jpk.__file__))
                   if f.startswith('smq') and f.endswith('.py') and 'rpe' not in f)
    assert names == sorted(PACKS)


@pytest.mark.parametrize("name", PACKS)
def test_operation_keys(name):
    """The operations in the JAX package's order (the processor spec's
    order, then the pack's _op_order), with and without qubit labels."""
    jp, tp = packs(name)
    assert [str(k) for k in tp.target_model('full').operations] == \
        [str(k) for k in jp.target_model('full').operations]
    qlbls = ['Q%d' % i for i in range(jp._Pack._nqubits)]
    if name not in ('smq2Q_XYI1', 'smq2Q_XYI2'):   # the JAX package fails there
        assert [str(k) for k in tp.target_model('full', qubit_labels=qlbls).operations] == \
            [str(k) for k in jp.target_model('full', qubit_labels=qlbls).operations]


@pytest.mark.parametrize("gate_type", ['full', 'full TP', 'static', 'CPTPLND'])
@pytest.mark.parametrize("name", PACKS)
def test_dense_targets(name, gate_type):
    """Every member's dense form within 1e-12, and the parameter counts."""
    jp, tp = packs(name)
    jm, tm = jp.target_model(gate_type), tp.target_model(gate_type)
    assert tm.num_params == jm.num_params
    for jd, td in ((jm.operations, tm.operations), (jm.preps, tm.preps)):
        for k in jd:
            assert np.max(np.abs(td[k].dense() - np.asarray(jd[k].to_dense()))) < 1e-12
    for k in jm.povms:
        assert np.max(np.abs(tm.povms[k].dense() - np.asarray(jm.povms[k].to_dense()))) < 1e-12


@pytest.mark.parametrize("name", PACKS)
def test_germs_and_fiducials(name):
    """Germs, lite germs and fiducials by string, on the default qubits and
    relabeled."""
    jp, tp = packs(name)
    qlbls = ['Q%d' % i for i in range(jp._Pack._nqubits)]
    for ql in (None, qlbls):
        for lite in (False, True):
            assert strs(tp.germs(lite=lite, qubit_labels=ql)) == \
                strs(jp.germs(lite=lite, qubit_labels=ql))
        assert strs(tp.prep_fiducials(ql)) == strs(jp.prep_fiducials(ql))
        assert strs(tp.meas_fiducials(ql)) == strs(jp.meas_fiducials(ql))
    with pytest.raises(ValueError):
        tp.germs(qubit_labels=qlbls + ['extra'])


@pytest.mark.parametrize("name", PACKS)
def test_fidpair_data(name):
    """pergerm_fidpair_dict (lite and not, default and relabeled qubits) and
    global_fidpairs."""
    jp, tp = packs(name)
    qlbls = ['Q%d' % i for i in range(jp._Pack._nqubits)]
    for lite in (True, False):
        assert tp._Pack.global_fidpairs(lite) == jp._Pack.global_fidpairs(lite)
        for ql in (None, qlbls):
            jd = jp._Pack.pergerm_fidpair_dict(ql, lite)
            td = tp._Pack.pergerm_fidpair_dict(ql, lite)
            assert (td is None) == (jd is None)
            if jd is not None:
                assert [(g.str, p) for g, p in td.items()] == [(g.str, p) for g, p in jd.items()]


@pytest.mark.parametrize("name", ONE_QUBIT)
def test_clifford_compilation(name):
    """The shortest word for each Clifford, or None where the gates do not
    reach all 24."""
    jp, tp = packs(name)
    jc, tc = jp._Pack.clifford_compilation(), tp._Pack.clifford_compilation()
    assert (tc is None) == (jc is None)
    if jc is not None:
        assert list(tc) == list(jc)
        assert [[tuple(w) for w in tc[k]] for k in tc] == [[tuple(w) for w in jc[k]] for k in jc]


_JAX_DESIGNS = {}


def _design_or_error(mod, **kw):
    try:
        return mod.create_gst_experiment_design(8, **kw), None
    except Exception as e:      # both packages must fail alike
        return None, type(e)


@pytest.mark.parametrize("fpr,lite", [(False, True), (False, False), (True, True),
                                      (True, False)])
@pytest.mark.parametrize("name", PACKS)
def test_design_lists(name, fpr, lite):
    """create_gst_experiment_design(8): the lists circuit for circuit and in
    order, or the same error in both (a pack without FPR data raises
    ValueError; the FPR data of smq2Q_XYI1/XYI2 index fiducials those packs
    lack, an IndexError in both)."""
    jp, tp = packs(name)
    # without FPR a design depends on the lite flag through its germs only,
    # so the JAX package's design is built once per germ list
    key = (name, fpr, lite) if fpr else (name, tuple(strs(jp.germs(lite=lite))))
    if key not in _JAX_DESIGNS:
        _JAX_DESIGNS[key] = _design_or_error(jp, fpr=fpr, lite=lite)
    jd, jerr = _JAX_DESIGNS[key]
    td, terr = _design_or_error(tp, fpr=fpr, lite=lite)
    assert terr == jerr
    if jd is not None:
        same_lists(jd.circuit_lists, td.circuit_lists)
        assert td.nested == jd.nested


@pytest.mark.parametrize("option", ['keep', 'fpr keep', 'germ limits', 'no nest',
                                    'truncated germ powers', 'length as exponent',
                                    'no lgst'])
@pytest.mark.parametrize("name", PACKS)
def test_design_options(name, option):
    """The circuit construction's options at maxL <= 2: random pair subsets
    (drawn in the same order), alone and on top of fiducial pairs (the
    pack's per-germ dict, or one list for every germ where the pack has no
    such dict), per-germ length
    limits, nest=False (which, as in the JAX package, still accumulates the
    plaquettes), the two other truncation schemes and include_lgst=False;
    on the first 8 prep and 6 measurement fiducials but where the pack's own
    pairs are used, which keeps the LGST circuits, most of the cost, few."""
    jp, tp = packs(name)
    mods = {"jax": (jp, j_lists), "torch": (tp, t_lists)}
    out = {}
    for which, (mod, build) in mods.items():
        fids = (mod.prep_fiducials(), mod.meas_fiducials())
        if option != 'fpr keep':     # the pack's pairs index all its fiducials
            fids = (fids[0][:8], fids[1][:6])
        germs = mod.germs()
        kw = {'keep': dict(keep_fraction=0.25, keep_seed=3),
              'fpr keep': dict(keep_fraction=0.5, keep_seed=5,
                               fid_pairs=mod._Pack.pergerm_fidpair_dict(lite=False)
                               or [(0, 0), (1, 1), (2, 0)]),
              'germ limits': dict(germ_length_limits={germs[-1]: 1, germs[1]: 2}),
              'no nest': dict(nest=False),
              'truncated germ powers': dict(trunc_scheme='truncated germ powers'),
              'length as exponent': dict(trunc_scheme='length as exponent'),
              'no lgst': dict(include_lgst=False)}[option]
        try:
            out[which] = build(mod.target_model("static"), *fids, germs, [1, 2], **kw), None
        except Exception as e:
            out[which] = None, type(e)
    assert out['torch'][1] == out['jax'][1]
    if out['jax'][0] is not None:
        same_lists(out['jax'][0], out['torch'][0])


def test_design_dataset_check():
    """dscheck: a circuit missing from the dataset raises, or is left out
    with action_if_missing='drop', as in the JAX package."""
    jp, tp = packs('smq1Q_XYI')
    jfull = jp.create_gst_experiment_design(4).circuit_lists[-1]
    tfull = tp.create_gst_experiment_design(4).circuit_lists[-1]
    jkeep = set(list(jfull)[::2])
    tkeep = set(list(tfull)[::2])
    with pytest.raises(ValueError):
        tp.create_gst_experiment_design(4, dscheck=tkeep)
    jd = jp.create_gst_experiment_design(4, dscheck=jkeep, action_if_missing='drop')
    td = tp.create_gst_experiment_design(4, dscheck=tkeep, action_if_missing='drop')
    same_lists(jd.circuit_lists, td.circuit_lists)
    assert len(td.circuit_lists[-1]) < len(tfull)


def test_fpr_without_data_raises():
    """fpr=True on a pack whose lite FPR data the reference never computed."""
    _, tp = packs('smq2Q_XYZICNOT')
    with pytest.raises(ValueError, match="No FPR information"):
        tp.create_gst_experiment_design(8, fpr=True)
