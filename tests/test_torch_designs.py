"""Serialization of reduced GST designs.  The JAX package writes neither the
fiducial pairs nor the keep options of a StandardGSTDesign and rebuilds its
lists from the germs alone, so a fiducial-pair-reduced design reads back as
the full design.  The port writes them, and reads every design back with the
lists it was written with."""

import pytest

import pygsti_tpu.modelpacks.smq2Q_XYICNOT as jmp
from pygsti_tpu.protocols.gst import StandardGSTDesign as JDesign

import pygsti_tpu_torch.modelpacks.smq2Q_XYICNOT as tmp
import pygsti_tpu_torch.modelpacks.smq1Q_XYI as tmp1
from pygsti_tpu_torch.baseobjs.nicelyserializable import NicelySerializable
from pygsti_tpu_torch.protocols.gst import StandardGSTDesign as TDesign

FPR_SIZES = [907, 1082, 1376]      # smq2Q_XYICNOT, fpr=True, maxL 1, 2, 4
FULL_SIZES = [907, 1861, 3527]


def sizes(design):
    return [len(l) for l in design.circuit_lists]


def round_trip(design):
    """Through the JSON text a checkpoint holds."""
    return NicelySerializable.loads(design.dumps())


def test_jax_package_reads_a_reduced_design_back_as_the_full_design():
    d = jmp.create_gst_experiment_design(4, fpr=True)
    assert sizes(d) == FPR_SIZES
    back = JDesign._from_nice_serialization(d._to_nice_serialization())
    assert sizes(back) == FULL_SIZES


@pytest.mark.parametrize("kw", [dict(fpr=True), dict(keep_fraction=0.25, keep_seed=3),
                                dict(fpr=True, keep_fraction=0.5, keep_seed=1)],
                         ids=['fpr', 'keep', 'fpr keep'])
def test_port_reads_a_reduced_design_back_as_written(kw):
    d = tmp.create_gst_experiment_design(4, **kw)
    if kw.get('fpr') and 'keep_fraction' not in kw:
        assert sizes(d) == FPR_SIZES
    back = round_trip(d)
    assert type(back) is TDesign
    assert [[c.str for c in l] for l in back.circuit_lists] == \
        [[c.str for c in l] for l in d.circuit_lists]
    assert back.keep_fraction == d.keep_fraction and back.keep_seed == d.keep_seed
    assert back.nested and back.maxlengths == [1, 2, 4]


def test_germ_length_limits_and_dataset_check_read_back():
    """Per-germ length limits are written; the circuits a dataset check left
    out stay out (the check is repeated against the circuits written)."""
    germs = tmp1.germs()
    d = TDesign(tmp1.target_model('static'), tmp1.prep_fiducials(), tmp1.meas_fiducials(),
                germs, [1, 2, 4, 8], germ_length_limits={germs[-1]: 2})
    back = round_trip(d)
    assert [[c.str for c in l] for l in back.circuit_lists] == \
        [[c.str for c in l] for l in d.circuit_lists]
    keep = set(list(d.circuit_lists[-1])[::3])
    checked = TDesign(tmp1.target_model('static'), tmp1.prep_fiducials(),
                      tmp1.meas_fiducials(), germs, [1, 2, 4], dscheck=keep,
                      action_if_missing='drop')
    back = round_trip(checked)
    assert sizes(back) == sizes(checked) and sizes(checked)[-1] < sizes(d)[2]


def test_port_reads_the_jax_packages_reduced_state_as_that_package_does():
    """A reduced design written by the JAX package holds no pairs: the port
    reads it back as the full design, as the JAX package does, and keeps the
    JAX package's lists circuit for circuit."""
    d = jmp.create_gst_experiment_design(4, fpr=True)
    back = NicelySerializable.loads(d.dumps())
    jback = JDesign._from_nice_serialization(d._to_nice_serialization())
    assert sizes(back) == FULL_SIZES
    assert [[c.str for c in l] for l in back.circuit_lists] == \
        [[c.str for c in l] for l in jback.circuit_lists]
