"""One-call GST drivers (counterpart of pygsti_tpu/drivers/longsequence.py).

Each driver takes a dataset or the name of a dataset file (read by
``io.read_dataset`` with its defaults), builds the design, runs the
protocol on `device` (the card by default) and returns its results.  As in
the JAX package, the protocols write their checkpoints into
``gst_checkpoints/`` under the working directory.
"""

from __future__ import annotations

import os
import pickle

from pygsti_tpu_torch.protocols.gst import (GateSetTomography, GateSetTomographyDesign,
                                            GSTBadFitOptions, GSTInitialModel, GSTObjFnBuilders,
                                            LinearGateSetTomography, StandardGST,
                                            StandardGSTDesign)
from pygsti_tpu_torch.protocols.modeltest import ModelTest
from pygsti_tpu_torch.protocols.protocol import ProtocolData


def _load_dataset(data_filename_or_set):
    if isinstance(data_filename_or_set, (str, os.PathLike)):
        from pygsti_tpu_torch.io.readers import read_dataset
        return read_dataset(os.fspath(data_filename_or_set))
    return data_filename_or_set


def _apply_advanced_options(advanced_options):
    """Protocol arguments from the legacy `advanced_options` dict: the keys
    'objective', 'max_iterations', 'tolerance', 'starting_point',
    'bad_fit_threshold' and 'estimate_label'; any other key raises
    ValueError, with the JAX package's message."""
    adv = dict(advanced_options or {})
    out = {}
    if 'objective' in adv:
        out['objfn_builders'] = GSTObjFnBuilders.create_from(objective=adv.pop('objective'))
    opt_kw = {}
    if 'max_iterations' in adv:
        opt_kw['maxiter'] = int(adv.pop('max_iterations'))
    if 'tolerance' in adv:
        opt_kw['tol'] = adv.pop('tolerance')
    if opt_kw:
        out['optimizer'] = opt_kw
    if 'starting_point' in adv:
        out['starting_point'] = adv.pop('starting_point')
    if 'bad_fit_threshold' in adv:
        out['badfit_options'] = GSTBadFitOptions(threshold=adv.pop('bad_fit_threshold'))
    if 'estimate_label' in adv:
        out['name'] = adv.pop('estimate_label')
    if adv:
        raise ValueError(
            "Unsupported advanced_options keys %s; supported: objective, "
            "max_iterations, tolerance, starting_point, bad_fit_threshold, "
            "estimate_label" % sorted(adv))
    return out


def _write_output_pkl(results, output_pkl):
    """Pickle `results` to `output_pkl`, a path or an open binary file
    (nothing when it is None)."""
    if output_pkl is None:
        return
    if hasattr(output_pkl, 'write'):
        pickle.dump(results, output_pkl)
    else:
        with open(output_pkl, 'wb') as f:
            pickle.dump(results, f)


def _run_gst(ds, design, target_model, gauge_opt_params, advanced_options, output_pkl,
             verbosity, device):
    adv = _apply_advanced_options(advanced_options)
    init = GSTInitialModel(target_model=target_model,
                           starting_point=adv.pop('starting_point', None))
    gaugeopt = 'stdgaugeopt' if gauge_opt_params is None else {'go0': gauge_opt_params}
    proto = GateSetTomography(init, gaugeopt_suite=gaugeopt, verbosity=verbosity,
                              name=adv.pop('name', 'GateSetTomography'), device=device, **adv)
    results = proto.run(ProtocolData(design, ds))
    _write_output_pkl(results, output_pkl)
    return results


def run_long_sequence_gst(data_filename_or_set, target_model, prep_fiducials, meas_fiducials,
                          germs, max_lengths, gauge_opt_params=None, advanced_options=None,
                          comm=None, mem_limit=None, output_pkl=None, verbosity=2,
                          device="cuda"):
    """Long-sequence GST of a StandardGSTDesign: from LGST where it can,
    chi2 stages then the Poisson logL, then 'stdgaugeopt' (or
    `gauge_opt_params` as the one gauge optimization 'go0')."""
    design = StandardGSTDesign(target_model, prep_fiducials, meas_fiducials, germs,
                               max_lengths)
    return _run_gst(_load_dataset(data_filename_or_set), design, target_model,
                    gauge_opt_params, advanced_options, output_pkl, verbosity, device)


def run_long_sequence_gst_base(data_filename_or_set, target_model, lsgst_lists,
                               gauge_opt_params=None, advanced_options=None, comm=None,
                               mem_limit=None, output_pkl=None, verbosity=2, device="cuda"):
    """run_long_sequence_gst on explicit circuit lists (one list of
    circuits is taken as the only list)."""
    if lsgst_lists and not isinstance(lsgst_lists[0], (list, tuple)) \
            and not hasattr(lsgst_lists[0], '__iter__'):
        lsgst_lists = [lsgst_lists]
    design = GateSetTomographyDesign(target_model, list(lsgst_lists))
    return _run_gst(_load_dataset(data_filename_or_set), design, target_model,
                    gauge_opt_params, advanced_options, output_pkl, verbosity, device)


def run_stdpractice_gst(data_filename_or_set, processorspec_or_model, prep_fiducials,
                        meas_fiducials, germs, max_lengths,
                        modes=('full TP', 'CPTPLND', 'Target'), gaugeopt_suite='stdgaugeopt',
                        comm=None, mem_limit=None, verbosity=2, device="cuda"):
    """StandardGST: one estimate per mode."""
    design = StandardGSTDesign(processorspec_or_model, prep_fiducials, meas_fiducials, germs,
                               max_lengths)
    proto = StandardGST(modes, gaugeopt_suite=gaugeopt_suite, verbosity=verbosity,
                        device=device)
    return proto.run(ProtocolData(design, _load_dataset(data_filename_or_set)))


def run_model_test(model_to_test, data_filename_or_set, target_model, prep_fiducials,
                   meas_fiducials, germs, max_lengths, verbosity=2, device="cuda"):
    """ModelTest of `model_to_test` on the data.  A filename is read as
    the other drivers read it (the JAX package passes the string on as the
    dataset)."""
    design = StandardGSTDesign(target_model, prep_fiducials, meas_fiducials, germs,
                               max_lengths)
    proto = ModelTest(model_to_test, target_model, verbosity=verbosity, device=device)
    return proto.run(ProtocolData(design, _load_dataset(data_filename_or_set)))


def run_linear_gst(data_filename_or_set, target_model, prep_fiducials, meas_fiducials,
                   gauge_opt_params=None, advanced_options=None, comm=None, mem_limit=None,
                   output_pkl=None, verbosity=2, device="cuda"):
    """LGST on an LGST-only design (no germs, max length 1), gauge-optimized
    on `device`.  LGST is a closed-form inversion: any `advanced_options`
    raise ValueError."""
    ds = _load_dataset(data_filename_or_set)
    design = StandardGSTDesign(target_model, prep_fiducials, meas_fiducials, [], [1])
    if advanced_options:
        raise ValueError("run_linear_gst takes no advanced_options (got %s)"
                         % sorted(advanced_options))
    proto = LinearGateSetTomography(
        target_model, verbosity=verbosity, device=device,
        gaugeopt_suite='stdgaugeopt' if gauge_opt_params is None else {'go0': gauge_opt_params})
    results = proto.run(ProtocolData(design, ds))
    _write_output_pkl(results, output_pkl)
    return results
