"""Free-form data simulators: per-circuit model quantities gathered into a
FreeformDataSet, and a shot-sampling simulator that makes a DataSet
(counterpart of pygsti_tpu/protocols/freeformsim.py)."""

from __future__ import annotations

import torch

from pygsti_tpu_torch import DTYPE
from pygsti_tpu_torch.data.freedataset import FreeformDataSet
from pygsti_tpu_torch.protocols.protocol import DataSimulator, ProtocolData


class FreeformDataSimulator(DataSimulator):
    """Computes a dict of data for each circuit via compute_freeform_data."""

    def compute_freeform_data(self, circuit):
        raise NotImplementedError

    def apply(self, edesign, memlimit=None, comm=None):
        ds = FreeformDataSet(circuits=list(edesign.all_circuits_needing_data))
        for c in edesign.all_circuits_needing_data:
            ds[c] = self.compute_freeform_data(c)
        return ds

    def run(self, edesign, memlimit=None, comm=None):
        return ProtocolData(edesign, self.apply(edesign, memlimit, comm))


class ModelFreeformSimulator(FreeformDataSimulator):
    """Per-circuit probabilities, final states and process matrices of a
    dict of models, computed on `device` and returned as numpy."""

    def __init__(self, models, device="cuda"):
        self.models = dict(models or {})
        self.device = device

    def compute_process_matrix(self, model, circuit, include_final_state=False,
                               include_probabilities=False):
        """The product of the circuit's layer superoperators (the first
        applied first); with the flags also (final state,) (effect
        probabilities,) from the default prep and the POVMs' effects."""
        model.register_circuit_layers([circuit])
        with torch.no_grad():
            t = model.tensors_fn()(torch.as_tensor(model.to_vector(), dtype=DTYPE,
                                                   device=self.device))
            keys = model.op_keys
            mx = torch.eye(model.dim, dtype=DTYPE, device=self.device)
            for lbl in circuit.layertup:
                mx = t.ops[keys.index(lbl)] @ mx
            final_state = mx @ t.preps[0]
            probs = t.effects @ final_state
        if not (include_final_state or include_probabilities):
            return mx.cpu().numpy()
        ret = [mx.cpu().numpy()]
        if include_final_state:
            ret.append(final_state.cpu().numpy())
        if include_probabilities:
            ret.append(probs.cpu().numpy())
        return tuple(ret)

    def compute_final_state(self, model, circuit, include_probabilities=False):
        out = self.compute_process_matrix(model, circuit, include_final_state=True,
                                          include_probabilities=include_probabilities)
        return out[1:] if include_probabilities else out[1]

    def compute_circuit_probabilities(self, model, circuit):
        return model.probabilities(circuit, device=self.device)

    def compute_freeform_data(self, circuit):
        data = {}
        for lbl, model in self.models.items():
            for outcome, p in self.compute_circuit_probabilities(model, circuit).items():
                key = outcome[0] if len(outcome) == 1 else str(outcome)
                data['%s probs %s' % (lbl, key)] = float(p)
        return data


class ModelDatasetSimulator(DataSimulator):
    """Shot sampling: a DataSet drawn from the model's outcome
    distributions by data.simulate_data."""

    def __init__(self, model, num_samples=1000, seed=None, sample_error='multinomial',
                 device="cuda"):
        self.model = model
        self.num_samples = num_samples
        self.seed = seed
        self.sample_error = sample_error
        self.device = device

    def run(self, edesign, memlimit=None, comm=None):
        from pygsti_tpu_torch.data.datasetconstruction import simulate_data
        ds = simulate_data(self.model, edesign.all_circuits_needing_data, self.num_samples,
                           sample_error=self.sample_error, seed=self.seed, device=self.device)
        return ProtocolData(edesign, ds)

