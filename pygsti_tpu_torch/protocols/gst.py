"""GST protocols: designs, GateSetTomography, LinearGateSetTomography,
StandardGST, results and checkpoints (counterpart of
pygsti_tpu/protocols/gst.py).

The fit and the gauge optimization run on the protocol's ``device``, the
card by default.  Not ported yet: the bad-fit actions (wildcard budgets and
robust re-weighting) and reading results back from a directory.

A mode whose members LGST cannot carry its estimate into (the Lindblad and
unitary families) starts from the mode's target, so that the fit keeps the
mode's parameterization; gauge-transforming such members raises
NotImplementedError, so these modes run with ``gaugeopt_suite=None``.  The JAX
package warms its gauge-opt executables in a background thread while the
fit runs; torch runs eagerly, there is nothing to compile, and the thread
has no counterpart here.
"""

from __future__ import annotations

import collections
import os
import time

from pygsti_tpu_torch.algorithms import core as _alg
from pygsti_tpu_torch.algorithms.gaugeopt import gaugeopt_to_target
from pygsti_tpu_torch.baseobjs.nicelyserializable import NicelySerializable
from pygsti_tpu_torch.baseobjs.profiler import Profiler
from pygsti_tpu_torch.baseobjs.verbosityprinter import VerbosityPrinter
from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.circuits.gstcircuits import create_lsgst_circuit_lists
from pygsti_tpu_torch.modelmembers import operations as _opm
from pygsti_tpu_torch.modelmembers import povms as _pvm
from pygsti_tpu_torch.modelmembers import states as _stm
from pygsti_tpu_torch.models.explicitmodel import ExplicitOpModel
from pygsti_tpu_torch.models.gaugegroup import (UnitaryGaugeGroup, TPSpamGaugeGroup,
                                                SpamGaugeGroup,
                                                default_gauge_group_for_model)
from pygsti_tpu_torch.objectivefns.objectivefns import (
    ObjectiveFunctionBuilder, RawPoissonPicDeltaLogLFunction,
    TimeIndependentMDCObjectiveFunction)
from pygsti_tpu_torch.optimize.simplerlm import SimplerLMOptimizer
from pygsti_tpu_torch.protocols.estimate import Estimate
from pygsti_tpu_torch.protocols.protocol import (Protocol, ProtocolResults,
                                                 CircuitListsDesign, ProtocolCheckpoint)


def _target_from_state(state):
    return ExplicitOpModel.from_nice_serialization(state['target_model']) \
        if 'target_model' in state else None


class GateSetTomographyDesign(CircuitListsDesign):
    """Circuit-lists design + a target model."""

    def __init__(self, processorspec_or_model, circuit_lists, all_circuits_needing_data=None,
                 qubit_labels=None, nested=False):
        super().__init__(circuit_lists, all_circuits_needing_data, qubit_labels, nested)
        self.target_model = processorspec_or_model

    def _to_nice_serialization(self):
        state = super()._to_nice_serialization()
        if hasattr(self.target_model, 'to_nice_serialization'):
            state['target_model'] = self.target_model.to_nice_serialization()
        return state

    @classmethod
    def _from_nice_serialization(cls, state):
        lists = [[Circuit(s) for s in cl] for cl in state['circuit_lists']]
        return GateSetTomographyDesign(_target_from_state(state), lists,
                                       [Circuit(s) for s in state['circuits']],
                                       state.get('qubit_labels'),
                                       state.get('nested', False))


class StandardGSTDesign(GateSetTomographyDesign):
    """Standard germs/fiducials/max-lengths design: the lists of
    make_lsgst_structs (circuits/gstcircuits.py), with its options --
    fiducial-pair reduction (``fiducial_pairs``, a list of (prep index,
    meas index) pairs or a dict germ -> such a list), random pair subsets
    (``keep_fraction``, ``keep_seed``), ``germ_length_limits``,
    ``op_label_aliases`` and a dataset check (``dscheck``,
    ``action_if_missing``).  ``verbosity`` and ``add_default_protocol`` are
    taken and, as in the JAX package, change nothing.

    Unlike the JAX package's, the serialization writes the fiducial pairs,
    the keep options and the germ length limits (not the aliases, which
    change no circuit), so that a reduced design
    reads back with the lists it was written with (the JAX package's reads
    back as the full design).  A dataset check is repeated on reading back
    against the circuits written, which keeps the circuits it kept.  A
    state the JAX package wrote holds no pairs, and reads back here as the
    full design, as it does there."""

    def __init__(self, target_model, prep_fiducials, meas_fiducials, germs, max_lengths,
                 germ_length_limits=None, fiducial_pairs=None, keep_fraction=1,
                 keep_seed=None, nest=True, op_label_aliases=None, dscheck=None,
                 action_if_missing="raise", qubit_labels=None, verbosity=0,
                 add_default_protocol=False):
        self.prep_fiducials = list(prep_fiducials)
        self.meas_fiducials = list(meas_fiducials)
        self.germs = list(germs)
        self.maxlengths = list(max_lengths)
        self.germ_length_limits = germ_length_limits
        self.fiducial_pairs = fiducial_pairs
        self.keep_fraction = keep_fraction
        self.keep_seed = keep_seed
        lists = create_lsgst_circuit_lists(
            target_model, self.prep_fiducials, self.meas_fiducials, self.germs,
            self.maxlengths, fid_pairs=fiducial_pairs, nest=nest,
            germ_length_limits=germ_length_limits, op_label_aliases=op_label_aliases,
            dscheck=dscheck, action_if_missing=action_if_missing, verbosity=verbosity,
            keep_fraction=keep_fraction, keep_seed=keep_seed)
        super().__init__(target_model, lists, qubit_labels=qubit_labels, nested=nest)

    def _to_nice_serialization(self):
        state = GateSetTomographyDesign._to_nice_serialization(self)
        state['prep_fiducials'] = [c.str for c in self.prep_fiducials]
        state['meas_fiducials'] = [c.str for c in self.meas_fiducials]
        state['germs'] = [c.str for c in self.germs]
        state['maxlengths'] = list(self.maxlengths)
        pairs = self.fiducial_pairs
        if isinstance(pairs, dict):
            state['fiducial_pairs_per_germ'] = [[g.str, [list(p) for p in pl]]
                                                for g, pl in pairs.items()]
        elif pairs is not None:
            state['fiducial_pairs'] = [list(p) for p in pairs]
        if self.germ_length_limits:
            state['germ_length_limits'] = [[g.str, int(L)]
                                           for g, L in self.germ_length_limits.items()]
        state['keep_fraction'] = self.keep_fraction
        state['keep_seed'] = self.keep_seed
        return state

    @classmethod
    def _from_nice_serialization(cls, state):
        if 'fiducial_pairs_per_germ' in state:
            pairs = {Circuit(g): [tuple(p) for p in pl]
                     for g, pl in state['fiducial_pairs_per_germ']}
        elif 'fiducial_pairs' in state:
            pairs = [tuple(p) for p in state['fiducial_pairs']]
        else:
            pairs = None
        limits = {Circuit(g): L for g, L in state.get('germ_length_limits', [])} or None
        # the port's states carry the keep options; a state without them was
        # written by the JAX package and reads back as that package reads it
        ported = 'keep_fraction' in state
        return cls(_target_from_state(state),
                   [Circuit(s) for s in state['prep_fiducials']],
                   [Circuit(s) for s in state['meas_fiducials']],
                   [Circuit(s) for s in state['germs']], state['maxlengths'],
                   germ_length_limits=limits, fiducial_pairs=pairs,
                   keep_fraction=state.get('keep_fraction', 1),
                   keep_seed=state.get('keep_seed'), nest=state.get('nested', True),
                   dscheck={Circuit(s) for s in state['circuits']} if ported else None,
                   action_if_missing="drop", qubit_labels=state.get('qubit_labels'))


def _lgst_keeps_parameterization(model):
    """Whether run_lgst can return its estimate in `model`'s own
    parameterization: every operation, prep and POVM is of a dense family
    (full, TP, static).  Any other member would come back fully
    parameterized.  Instruments are not estimated: run_lgst carries the
    target's into its estimate unchanged, as the JAX package does."""
    dense = (_opm.FullArbitraryOp, _opm.FullTPOp, _opm.StaticArbitraryOp,
             _stm.FullState, _stm.TPState, _stm.StaticState,
             _pvm.UnconstrainedPOVM, _pvm.TPPOVM)
    return all(isinstance(obj, dense) for members in (model.operations, model.preps,
                                                      model.povms)
               for obj in members.values())


class GSTInitialModel(NicelySerializable):
    """How to seed the GST optimization.

    starting_point: "User-supplied-Model", "target", "LGST" or
    "LGST-if-possible" (the default without a model).  The LGST estimate is
    used only when every member of the target is of a dense family (full,
    TP, static), which LGST can fill; for any other target (Lindblad,
    unitary members) "LGST-if-possible" starts from a copy of the target, so
    the fit keeps the target's parameterization, and "LGST" raises
    ValueError."""

    @classmethod
    def cast(cls, obj):
        if isinstance(obj, cls):
            return obj
        if obj is None:
            return cls()
        if isinstance(obj, str):
            return cls(starting_point=obj)
        return cls(model=obj)

    def __init__(self, model=None, target_model=None, starting_point=None,
                 depolarize_start=0):
        self.model = model
        self.target_model = target_model
        if starting_point is None:
            starting_point = "User-supplied-Model" if model is not None else "LGST-if-possible"
        self.starting_point = starting_point
        self.depolarize_start = depolarize_start

    def retrieve_model(self, edesign, gaugeopt_target, dataset, comm=None):
        target = self.target_model if self.target_model is not None else edesign.target_model
        if self.starting_point == "User-supplied-Model":
            mdl = self.model
        elif self.starting_point in ("LGST", "LGST-if-possible"):
            mdl = None
            if not _lgst_keeps_parameterization(target):
                if self.starting_point == "LGST":
                    raise ValueError(
                        "Cannot start from LGST: the target has members that LGST "
                        "cannot fill (it would return them fully parameterized); "
                        "use starting_point='target' or 'LGST-if-possible'")
            elif hasattr(edesign, 'prep_fiducials'):
                # "LGST-if-possible" starts from the target when LGST fails
                # (data missing for a fiducial pair, a singular frame):
                # the JAX package's documented behaviour
                try:
                    mdl = _alg.run_lgst(dataset, edesign.prep_fiducials,
                                        edesign.meas_fiducials, target.copy())
                except Exception:
                    if self.starting_point == "LGST":
                        raise
                    mdl = None
            elif self.starting_point == "LGST":
                raise ValueError("Cannot run LGST: design has no fiducials")
            if mdl is None:
                mdl = target.copy()
        elif self.starting_point == "target":
            mdl = target.copy()
        else:
            raise ValueError("Invalid starting point %r" % self.starting_point)
        if self.depolarize_start > 0:
            mdl = mdl.depolarize(op_noise=self.depolarize_start)
        return mdl


class GSTBadFitOptions(NicelySerializable):
    """What to do when the GST fit is bad."""

    @classmethod
    def cast(cls, obj):
        if isinstance(obj, cls):
            return obj
        if obj is None:
            return cls()
        if isinstance(obj, dict):
            return cls(**obj)
        raise ValueError("Cannot cast %r" % (obj,))

    def __init__(self, threshold=2.0, actions=(), wildcard_budget_includes_spam=True,
                 wildcard_smart_init=True, wildcard_methods=('neldermead',),
                 wildcard_percentile=0.05):
        self.threshold = threshold
        self.actions = tuple(actions)
        self.wildcard_budget_includes_spam = wildcard_budget_includes_spam
        self.wildcard_methods = tuple(wildcard_methods)
        self.wildcard_percentile = wildcard_percentile


class GSTObjFnBuilders(NicelySerializable):
    """Iteration + final objective builders."""

    @classmethod
    def cast(cls, obj):
        if isinstance(obj, cls):
            return obj
        if obj is None:
            return cls.create_from()
        if isinstance(obj, dict):
            return cls.create_from(**obj)
        if isinstance(obj, (list, tuple)):
            return cls(*obj)
        raise ValueError("Cannot cast %r" % (obj,))

    @classmethod
    def create_from(cls, objective='logl', freq_weighted_chi2=False,
                    always_perform_mle=False, only_perform_mle=False):
        chi2_builder = ObjectiveFunctionBuilder.create_from('chi2', freq_weighted_chi2)
        mle_builder = ObjectiveFunctionBuilder.create_from('logl')
        if objective == "chi2":
            return cls([chi2_builder], [])
        elif objective == "logl":
            if always_perform_mle:
                it = [mle_builder] if only_perform_mle else [chi2_builder, mle_builder]
                return cls(it, [])
            return cls([chi2_builder], [mle_builder])
        raise ValueError("Invalid objective: %r" % objective)

    def __init__(self, iteration_builders, final_builders=()):
        self.iteration_builders = list(iteration_builders)
        self.final_builders = list(final_builders)


class GSTGaugeOptSuite(NicelySerializable):
    """Named gauge-optimization suites.

    'stdgaugeopt' = 3 stages: (1) the model's default group, frobenius on
    gates+spam, (2) unitary group, gates only, (3) spam group, spam only,
    with the SPAM positivity penalty.
    """

    @classmethod
    def cast(cls, obj):
        if isinstance(obj, cls):
            return obj
        if obj is None:
            return cls(gaugeopt_suite_names=None)
        if isinstance(obj, str):
            return cls(gaugeopt_suite_names=(obj,))
        if isinstance(obj, (tuple, list)):
            return cls(gaugeopt_suite_names=obj)
        if isinstance(obj, dict):
            return cls(gaugeopt_argument_dicts=obj)
        raise ValueError("Cannot cast %r" % (obj,))

    def __init__(self, gaugeopt_suite_names=None, gaugeopt_argument_dicts=None,
                 gaugeopt_target=None):
        self.gaugeopt_suite_names = tuple(gaugeopt_suite_names) \
            if gaugeopt_suite_names is not None else None
        self.gaugeopt_argument_dicts = dict(gaugeopt_argument_dicts) \
            if gaugeopt_argument_dicts is not None else None
        self.gaugeopt_target = gaugeopt_target

    def is_empty(self):
        return self.gaugeopt_suite_names is None and self.gaugeopt_argument_dicts is None

    def to_dictionary(self, model, unreliable_ops=(), verbosity=0):
        """Resolve suite names into gauge-opt argument dicts."""
        out = collections.OrderedDict()
        if self.gaugeopt_argument_dicts is not None:
            out.update(self.gaugeopt_argument_dicts)
        if self.gaugeopt_suite_names is None:
            return out
        for name in self.gaugeopt_suite_names:
            if name in ('stdgaugeopt', 'stdgaugeopt-unreliable2Q'):
                gg = default_gauge_group_for_model(model)
                stages = []
                if gg.name in ("Full", "TP"):
                    stages.append({'item_weights': {'gates': 1.0, 'spam': 1.0}})
                stages.append({'gauge_group': UnitaryGaugeGroup(model.dim, model.basis),
                               'item_weights': {'gates': 1.0, 'spam': 0.0}})
                s3gg = SpamGaugeGroup(model.dim) if gg.name == "Full" \
                    else TPSpamGaugeGroup(model.dim)
                stages.append({'gauge_group': s3gg,
                               'item_weights': {'gates': 0.0, 'spam': 1.0},
                               'spam_penalty_factor': 1.0})
                out[name] = {'stages': stages}
            elif name == 'TPpenalty':
                out[name] = {'item_weights': {'gates': 1.0, 'spam': 1.0}}
            elif name in ('varySpam', 'varySpamWt', 'varyValidSpamWt', 'toggleValidSpam'):
                for wt in (1e-4, 1e-1):
                    out['%s.spam%g' % (name, wt)] = {'item_weights': {'gates': 1.0, 'spam': wt}}
            elif name == 'unreliable2Q':
                out[name] = {'item_weights': {'gates': 1.0, 'spam': 1.0}}
            elif name == 'none':
                continue
            else:
                raise ValueError("Unknown gauge opt suite %r" % name)
        return out


class ModelEstimateResults(ProtocolResults):
    """GST results: dict of named Estimates."""

    def __init__(self, data, protocol_instance, init_circuits=True):
        super().__init__(data, protocol_instance)
        self.estimates = collections.OrderedDict()
        if init_circuits and isinstance(self.data.edesign, CircuitListsDesign):
            self.circuit_lists = collections.OrderedDict(
                [('iteration %d' % i, cl) for i, cl in
                 enumerate(self.data.edesign.circuit_lists)])
            self.circuit_lists['final'] = self.data.edesign.circuit_lists[-1]
        else:
            self.circuit_lists = collections.OrderedDict()

    def add_estimate(self, estimate, estimate_key='default'):
        estimate.parent = self
        self.estimates[estimate_key] = estimate

    def to_nice_serialization(self):
        state = {'protocol_name': self.protocol.name,
                 'circuit_lists': {k: [c.str for c in cl]
                                   for k, cl in self.circuit_lists.items()},
                 'estimates': {}}
        for name, est in self.estimates.items():
            models = {k: m.to_nice_serialization()
                      for k, m in est.models.items()
                      if hasattr(m, 'to_nice_serialization')}
            params = {k: v for k, v in est.parameters.items()
                      if isinstance(v, (int, float, str, bool, type(None)))}
            state['estimates'][name] = {
                'models': models, 'parameters': params,
                'goparameters_keys': list(est.goparameters.keys())}
        return state

    def add_model_test(self, target_model, themodel, estimate_key='test', gaugeopt_keys="auto",
                       verbosity=0, device="cuda"):
        """Add an estimate that is just a fixed model evaluated against the data."""
        final_circuits = list(self.circuit_lists.get('final',
                              self.data.edesign.all_circuits_needing_data))
        obj = TimeIndependentMDCObjectiveFunction(
            RawPoissonPicDeltaLogLFunction(), themodel, self.data.dataset, final_circuits,
            device=device)
        params = {'final_objfn_value': 2 * obj.fn(),
                  'final_dof': self.data.dataset.degrees_of_freedom(final_circuits)}
        est = Estimate(self, {'target': target_model, 'final iteration estimate': themodel},
                       params)
        self.add_estimate(est, estimate_key)
        return est

    def __getitem__(self, key):
        return self.estimates[key]

    def keys(self):
        return self.estimates.keys()

    def __str__(self):
        return ("ModelEstimateResults with estimates: %s" % list(self.estimates.keys()))


def _open_checkpoint(checkpoint, checkpoint_path, default_name, checkpoint_cls, name):
    """(checkpoint, path stem) for a run with checkpointing on: the caller's
    checkpoint or a fresh one, and the directory of the stem created."""
    if checkpoint_path is None:
        checkpoint_path = 'gst_checkpoints/' + (name or default_name)
    os.makedirs(os.path.dirname(checkpoint_path) or '.', exist_ok=True)
    if checkpoint is None:
        checkpoint = checkpoint_cls(name=name)
    elif not isinstance(checkpoint, checkpoint_cls):
        raise TypeError("'checkpoint' must be a %s" % checkpoint_cls.__name__)
    return checkpoint, checkpoint_path


class GateSetTomography(Protocol):
    """The main long-sequence GST protocol."""

    def __init__(self, initial_model=None, gaugeopt_suite='stdgaugeopt',
                 objfn_builders=None, optimizer=None, badfit_options=None,
                 verbosity=2, name=None, device="cuda"):
        super().__init__(name)
        self.initial_model = GSTInitialModel.cast(initial_model)
        self.gaugeopt_suite = GSTGaugeOptSuite.cast(gaugeopt_suite)
        self.objfn_builders = GSTObjFnBuilders.cast(objfn_builders)
        self.optimizer = SimplerLMOptimizer.cast(optimizer)
        self.badfit_options = GSTBadFitOptions.cast(badfit_options)
        self.verbosity = verbosity
        self.device = device

    def run(self, data, memlimit=None, comm=None, checkpoint=None, checkpoint_path=None,
            disable_checkpointing=False, device=None):
        """Fit, build the Estimate, gauge-optimize.  `device` overrides the
        protocol's own for this run.

        Unless `disable_checkpointing`, a checkpoint is written after every
        circuit list as ``{checkpoint_path}_iteration_{i}.json`` (default
        stem ``gst_checkpoints/<name>`` under the working directory); pass
        one read back from such a file as `checkpoint` to resume."""
        device = self.device if device is None else device
        printer = VerbosityPrinter.create_printer(self.verbosity)
        edesign = data.edesign
        ds = data.dataset
        target = edesign.target_model

        circuit_lists = edesign.circuit_lists
        n_iters = len(circuit_lists)

        if disable_checkpointing:
            checkpoint = None
            starting_index = 0
        else:
            checkpoint, checkpoint_path = _open_checkpoint(
                checkpoint, checkpoint_path, 'GateSetTomography',
                GateSetTomographyCheckpoint, self.name)
            starting_index = checkpoint.last_completed_iter + 1
            if starting_index > 0:
                printer.log("Resuming from checkpoint: %d of %d iterations done"
                            % (starting_index, n_iters))

        if checkpoint is not None and checkpoint.mdl_list:
            seed_model = checkpoint.mdl_list[-1].copy()
            models = [m.copy() for m in checkpoint.mdl_list]
        else:
            seed_model = self.initial_model.retrieve_model(edesign, None, ds)
            models = []

        profiler = Profiler()
        tstart = time.time()
        opt_results = []
        gen = _alg.iterative_gst_generator(
            ds, seed_model, circuit_lists, self.optimizer,
            self.objfn_builders.iteration_builders, self.objfn_builders.final_builders,
            starting_index=starting_index, verbosity=self.verbosity - 1,
            profiler=profiler, device=device)
        for i in range(starting_index, n_iters):
            iter_opt_results, mdl = next(gen)
            models.append(mdl)
            opt_results.append(iter_opt_results)
            if checkpoint is not None:
                checkpoint.mdl_list = models
                checkpoint.last_completed_iter = i
                checkpoint.last_completed_circuit_list = list(circuit_lists[i])
                if i == n_iters - 1:
                    checkpoint.final_objfn = \
                        iter_opt_results[-1].chi2_k_distributed_qty
                with profiler.timing('checkpoint writes'):
                    checkpoint.write("%s_iteration_%d.json" % (checkpoint_path, i))
        fit_time = time.time() - tstart

        results = ModelEstimateResults(data, self)
        final_circuits = list(circuit_lists[-1])
        if opt_results:
            final_objfn_value = opt_results[-1][-1].chi2_k_distributed_qty
        else:  # fully resumed from checkpoint
            final_objfn_value = checkpoint.final_objfn
            if final_objfn_value is None:
                obj = TimeIndependentMDCObjectiveFunction(
                    RawPoissonPicDeltaLogLFunction(), models[-1], ds, final_circuits,
                    device=device)
                final_objfn_value = 2 * obj.fn()
        dof = ds.degrees_of_freedom(final_circuits) - models[-1].num_params
        params = {
            'protocol': self,
            'final_objfn_value': final_objfn_value,
            'final_dof': max(dof, 1),
            'fit_time': fit_time,
            'raw_objective_values': [[r.f for r in rs] for rs in opt_results],
            'optimizer_results': opt_results,
        }
        est = Estimate.create_gst_estimate(results, target, seed_model, models, params)
        results.add_estimate(est, estimate_key=self.name)
        with profiler.timing('gauge optimization + badfit'):
            _add_gaugeopt_and_badfit(results, self.name, target, self.gaugeopt_suite,
                                     self.badfit_options, printer,
                                     optimizer=self.optimizer, device=device)
        est.parameters['profiler'] = dict(profiler.timers)
        printer.log("Phase times:\n" + profiler.format_times(), 3)
        return results


class LinearGateSetTomography(Protocol):
    """LGST protocol: the linear-inversion estimate (numpy on the host),
    gauge-optimized on `device`."""

    def __init__(self, target_model=None, gaugeopt_suite='stdgaugeopt', verbosity=2,
                 name=None, device="cuda"):
        super().__init__(name)
        self.target_model = target_model
        self.gaugeopt_suite = GSTGaugeOptSuite.cast(gaugeopt_suite)
        self.verbosity = verbosity
        self.device = device

    def run(self, data, memlimit=None, comm=None, device=None):
        device = self.device if device is None else device
        printer = VerbosityPrinter.create_printer(self.verbosity)
        edesign = data.edesign
        target = self.target_model if self.target_model is not None else edesign.target_model
        mdl_lgst = _alg.run_lgst(data.dataset, edesign.prep_fiducials,
                                 edesign.meas_fiducials, target,
                                 verbosity=self.verbosity - 1)
        results = ModelEstimateResults(data, self, init_circuits=False)
        est = Estimate(results, {'target': target, 'seed': mdl_lgst,
                                 'final iteration estimate': mdl_lgst}, {})
        results.add_estimate(est, estimate_key=self.name)
        _add_gaugeopt_and_badfit(results, self.name, target, self.gaugeopt_suite,
                                 GSTBadFitOptions(), printer, device=device)
        return results


class StandardGST(Protocol):
    """Run GST with several parameterizations (any type of
    models/modelconstruction.py; the mode 'Target' and every key of
    `models_to_test` score a fixed model).  The default modes are the JAX
    package's.  A Lindblad or unitary mode is fitted from its converted
    target with its own members (GSTInitialModel), and its members cannot be
    gauge-transformed: with a gauge-opt suite such a mode raises
    NotImplementedError after its fit, so pass ``gaugeopt_suite=None``."""

    def __init__(self, modes=('full TP', 'CPTPLND', 'Target'), gaugeopt_suite='stdgaugeopt',
                 target_model=None, models_to_test=None, objfn_builders=None,
                 optimizer=None, badfit_options=None, verbosity=2, name=None,
                 device="cuda"):
        super().__init__(name)
        if isinstance(modes, str):
            modes = modes.split(',')
        self.modes = tuple(modes)
        self.gaugeopt_suite = GSTGaugeOptSuite.cast(gaugeopt_suite)
        self.target_model = target_model
        self.models_to_test = models_to_test or {}
        self.objfn_builders = objfn_builders
        self.optimizer = optimizer
        self.badfit_options = badfit_options
        self.verbosity = verbosity
        self.device = device

    def run(self, data, memlimit=None, comm=None, checkpoint=None, checkpoint_path=None,
            disable_checkpointing=False, device=None):
        device = self.device if device is None else device
        printer = VerbosityPrinter.create_printer(self.verbosity)
        edesign = data.edesign
        target = self.target_model if self.target_model is not None else edesign.target_model

        if disable_checkpointing:
            checkpoint = None
        else:
            checkpoint, checkpoint_path = _open_checkpoint(
                checkpoint, checkpoint_path, 'StandardGST', StandardGSTCheckpoint,
                self.name)

        results = ModelEstimateResults(data, self)
        for mode in self.modes:
            printer.log("-- Performing '%s' gate set tomography --" % mode)
            if mode == "Target" or mode in self.models_to_test:
                themodel = target.copy() if mode == "Target" else self.models_to_test[mode]
                results.add_model_test(target, themodel, estimate_key=mode, device=device)
            else:
                gst = GateSetTomography(
                    GSTInitialModel(target_model=_convert_target(target, mode)),
                    self.gaugeopt_suite, self.objfn_builders, self.optimizer,
                    self.badfit_options, verbosity=self.verbosity - 1, name=mode,
                    device=device)
                if checkpoint is None:
                    sub_results = gst.run(data, disable_checkpointing=True)
                else:
                    child = checkpoint.children.get(mode)
                    if child is None:
                        child = GateSetTomographyCheckpoint(name=mode)
                        checkpoint.children[mode] = child
                    sub_results = gst.run(
                        data, checkpoint=child,
                        checkpoint_path="%s_%s" % (checkpoint_path, mode))
                results.add_estimate(sub_results.estimates[mode], estimate_key=mode)
            if checkpoint is not None:
                if mode not in checkpoint.completed_modes:
                    checkpoint.completed_modes.append(mode)
                checkpoint.write("%s.json" % checkpoint_path)
        return results


def _convert_target(target, parameterization):
    """A copy of `target` with every member re-made in the given
    parameterization from its dense value (any type that
    models/modelconstruction.py builds)."""
    m = target.copy()
    m.set_all_parameterizations(parameterization)
    return m


def _add_gaugeopt_and_badfit(results, estlbl, target_model, gaugeopt_suite,
                             badfit_options, printer, optimizer=None, device="cuda"):
    """Add the suite's gauge-optimized models to the estimate, then the
    bad-fit handling.  What each gauge-opt stage did (steps, seconds,
    objective before and after) is kept in
    ``estimate.parameters['gaugeopt_stats'][label]``, one dict per stage."""
    est = results.estimates[estlbl]
    if gaugeopt_suite is not None and not gaugeopt_suite.is_empty():
        mdl = est.models['final iteration estimate']
        godict = gaugeopt_suite.to_dictionary(mdl)
        go_target = gaugeopt_suite.gaugeopt_target \
            if gaugeopt_suite.gaugeopt_target is not None else target_model
        all_stats = est.parameters.setdefault('gaugeopt_stats', {})
        for golbl, goparams in godict.items():
            stages = goparams.get('stages', [goparams])
            cur = mdl
            t0 = time.time()
            all_stats[golbl] = []
            for stage in stages:
                stats = {}
                cur = gaugeopt_to_target(cur, go_target, device=device, stats=stats,
                                         **dict(stage))
                all_stats[golbl].append(stats)
            est.models[golbl] = cur
            est.goparameters[golbl] = goparams
            printer.log("  -- Added gauge-optimized result '%s' (%.1fs)"
                        % (golbl, time.time() - t0))
    if badfit_options is not None:
        _add_badfit_estimates(results, estlbl, badfit_options)


def _add_badfit_estimates(results, estlbl, badfit_options):
    """When the fit is bad (N_sigma above the threshold), apply the bad-fit
    actions.  With no actions (the default) nothing happens, as in the JAX
    package; the actions themselves ('wildcard', 'wildcard1d', 'robust',
    'Robust' and their '+' forms) arrive with the wildcard budget."""
    nsigma = results.estimates[estlbl].misfit_sigma()
    if nsigma is None or nsigma <= badfit_options.threshold or not badfit_options.actions:
        return
    raise NotImplementedError(
        "bad-fit actions %s are not ported yet (ROADMAP.md lists "
        "objectivefns/wildcardbudget.py among the modules to port)"
        % (badfit_options.actions,))


class GateSetTomographyCheckpoint(ProtocolCheckpoint):
    """Per-iteration GST checkpoint.

    Written as ``{checkpoint_path}_iteration_{i}.json`` after each
    circuit-list iteration by ``GateSetTomography.run``; pass the object
    read back from such a file as ``run(..., checkpoint=)`` to resume after
    the completed iterations.  A checkpoint the JAX package wrote reads
    here too."""

    def __init__(self, mdl_list=None, last_completed_iter=-1, last_completed_circuit_list=None,
                 final_objfn=None, name=None, parent=None):
        super().__init__(name, parent)
        self.mdl_list = mdl_list or []
        self.last_completed_iter = last_completed_iter
        self.last_completed_circuit_list = last_completed_circuit_list
        self.final_objfn = final_objfn

    def _to_nice_serialization(self):
        return {
            'name': self.name,
            'mdl_list': [m.to_nice_serialization() for m in self.mdl_list],
            'last_completed_iter': self.last_completed_iter,
            'last_completed_circuit_list':
                [c.str for c in (self.last_completed_circuit_list or [])],
            'final_objfn': self.final_objfn,
        }

    @classmethod
    def _from_nice_serialization(cls, state):
        mdls = [NicelySerializable.from_nice_serialization(s)
                for s in state.get('mdl_list', [])]
        cl = [Circuit(s) for s in state.get('last_completed_circuit_list', [])]
        return cls(mdls, state.get('last_completed_iter', -1), cl or None,
                   state.get('final_objfn'), state.get('name'))


class StandardGSTCheckpoint(ProtocolCheckpoint):
    """Multi-mode checkpoint: one child GateSetTomographyCheckpoint per
    StandardGST mode, and the modes completed."""

    def __init__(self, children=None, completed_modes=None, name=None, parent=None):
        super().__init__(name, parent)
        self.children = children or {}
        self.completed_modes = list(completed_modes or [])

    def _to_nice_serialization(self):
        return {
            'name': self.name,
            'children': {k: v.to_nice_serialization()
                         for k, v in self.children.items()},
            'completed_modes': list(self.completed_modes),
        }

    @classmethod
    def _from_nice_serialization(cls, state):
        children = {k: NicelySerializable.from_nice_serialization(v)
                    for k, v in state.get('children', {}).items()}
        return cls(children, state.get('completed_modes', []), state.get('name'))


# shorthand aliases, as in the JAX package
GSTDesign = GateSetTomographyDesign
GST = GateSetTomography
LGST = LinearGateSetTomography
