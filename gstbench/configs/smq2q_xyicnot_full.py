"""smq2Q_XYICNOT in the 'full' parameterization: the program's model pack
(the configuration's `modelpack`) and its plain reference
(reference/models.py FullGateSet)."""

import importlib

from gstbench.reference.models import FullGateSet


def _pack(cfg):
    return importlib.import_module('pygsti_tpu_torch.modelpacks.' + cfg['modelpack'])


def reference(cfg):
    return FullGateSet(cfg)


def truth(cfg, ref):
    """The data's truth: the 'full TP' target depolarized on ops and prep."""
    t = cfg['truth']
    return ref.theta_depolarized(t['depolarize_ops'], t['depolarize_spam'])


def start_model(cfg):
    """The program's fit start: the pack's target in 'full'."""
    return _pack(cfg).target_model(cfg['parameterization'])


def design_circuits(cfg, device):
    """The nested GST lists of the pack at the configuration's max lengths."""
    from pygsti_tpu_torch.circuits.gstcircuits import create_lsgst_circuit_lists
    mp = _pack(cfg)
    lists = create_lsgst_circuit_lists(mp.target_model('full'), mp.prep_fiducials(),
                                       mp.meas_fiducials(), mp.germs(), cfg['max_lengths'])
    return list(lists[-1]), [len(l) for l in lists]
