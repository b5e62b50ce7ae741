"""ModelTest: a fixed model evaluated against data, with no optimization
(counterpart of pygsti_tpu/protocols/modeltest.py).

Each circuit list's objective is built and evaluated per circuit only: the
objective's Jacobian functions are made but never called, so a 5-qubit
model costs its probabilities and nothing more.  Completed lists are
written as checkpoints and skipped on resume.
"""

from __future__ import annotations

import numpy as np

from pygsti_tpu_torch.baseobjs.verbosityprinter import VerbosityPrinter
from pygsti_tpu_torch.objectivefns.objectivefns import ObjectiveFunctionBuilder
from pygsti_tpu_torch.protocols.estimate import Estimate
from pygsti_tpu_torch.protocols.gst import ModelEstimateResults, _open_checkpoint
from pygsti_tpu_torch.protocols.protocol import Protocol, ProtocolCheckpoint


class ModelTest(Protocol):
    """Tests a model against data without optimization."""

    def __init__(self, model_to_test, target_model=None, gaugeopt_suite=None,
                 objfn_builder=None, badfit_options=None, verbosity=2, name=None,
                 device="cuda"):
        super().__init__(name)
        self.model_to_test = model_to_test
        self.target_model = target_model
        self.objfn_builder = ObjectiveFunctionBuilder.cast(objfn_builder or 'logl')
        self.verbosity = verbosity
        self.device = device

    def run(self, data, memlimit=None, comm=None, checkpoint=None, checkpoint_path=None,
            disable_checkpointing=False):
        """Results with one estimate, keyed by the protocol's name, whose
        'final_objfn_value' is the last list's chi2-distributed objective
        (2 DeltaLogL for 'logl') and 'final_dof' the data's degrees of
        freedom on it.  Checkpoints are written as
        ``{checkpoint_path}_iteration_{i}.json`` (default path
        gst_checkpoints/<name>) unless `disable_checkpointing`."""
        printer = VerbosityPrinter.create_printer(self.verbosity)
        edesign, ds = data.edesign, data.dataset
        target = self.target_model if self.target_model is not None else \
            getattr(edesign, 'target_model', None)
        circuit_lists = getattr(edesign, 'circuit_lists', [edesign.all_circuits_needing_data])
        if disable_checkpointing:
            checkpoint, start = None, 0
        else:
            checkpoint, checkpoint_path = _open_checkpoint(
                checkpoint, checkpoint_path, 'ModelTest', ModelTestCheckpoint, self.name)
            start = checkpoint.last_completed_iter + 1
            if start > 0:
                printer.log("Resuming ModelTest from checkpoint: %d of %d iterations done"
                            % (start, len(circuit_lists)))
        objfn_vals = list(checkpoint.objfn_vals[:start]) if checkpoint else []
        percircuit_by_iter = [np.asarray(pc) for pc in
                              (checkpoint.percircuit_vals[:start] if checkpoint else [])]
        for i, cl in enumerate(circuit_lists):
            if i < start:
                continue
            obj = self.objfn_builder.build(self.model_to_test, ds, list(cl), device=self.device)
            # without penalties the per-circuit terms (the omitted-probability
            # correction included) sum to fn(): one simulation gives both
            pc = obj.percircuit()
            total = obj.fn() if obj.penalties else float(np.sum(pc))
            objfn_vals.append(obj.chi2k_distributed_qty(total))
            percircuit_by_iter.append(pc)
            if checkpoint is not None:
                checkpoint.objfn_vals = [float(v) for v in objfn_vals]
                checkpoint.percircuit_vals = [list(map(float, p)) for p in percircuit_by_iter]
                checkpoint.last_completed_iter = i
                checkpoint.write("%s_iteration_%d.json" % (checkpoint_path, i))
        final_circuits = list(circuit_lists[-1])
        dof = ds.degrees_of_freedom(final_circuits)
        results = ModelEstimateResults(data, self,
                                       init_circuits=hasattr(edesign, 'circuit_lists'))
        params = {'final_objfn_value': objfn_vals[-1], 'final_dof': dof,
                  'objfn_values_by_iter': objfn_vals}
        models = {'final iteration estimate': self.model_to_test,
                  'test model': self.model_to_test}
        if target is not None:
            models['target'] = target
        est = Estimate(results, models, params)
        results.add_estimate(est, estimate_key=self.name)
        nsig = est.misfit_sigma()
        printer.log("ModelTest: 2*dlogl=%g, k=%d, Nsigma=%.2f"
                    % (objfn_vals[-1], dof, nsig if nsig is not None else np.nan))
        return results


class ModelTestCheckpoint(ProtocolCheckpoint):
    """The objective value and per-circuit terms of each completed circuit
    list; ModelTest.run resumes after them.  A checkpoint the JAX package
    wrote reads here too."""

    def __init__(self, last_completed_iter=-1, objfn_vals=None, percircuit_vals=None,
                 name=None, parent=None):
        super().__init__(name, parent)
        self.last_completed_iter = last_completed_iter
        self.objfn_vals = objfn_vals or []
        self.percircuit_vals = percircuit_vals or []

    def _to_nice_serialization(self):
        return {'name': self.name, 'last_completed_iter': self.last_completed_iter,
                'objfn_vals': [float(v) for v in self.objfn_vals],
                'percircuit_vals': [list(map(float, p)) for p in self.percircuit_vals]}

    @classmethod
    def _from_nice_serialization(cls, state):
        return cls(state.get('last_completed_iter', -1), state.get('objfn_vals', []),
                   state.get('percircuit_vals', []), state.get('name'))
