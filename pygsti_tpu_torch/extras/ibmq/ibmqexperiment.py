"""IBMQExperiment: stage an experiment design for IBM Q, submit via qiskit
(when installed), and convert retrieved job results into a DataSet
(counterpart of pygsti_tpu/extras/ibmq/ibmqexperiment.py).  Staging,
checkpoints and result ingestion need no qiskit.
"""

from __future__ import annotations

import json
import os
import pathlib

import numpy as np

from pygsti_tpu_torch.data.dataset import DataSet
from pygsti_tpu_torch.protocols.protocol import ProtocolData


def _require_qiskit():
    try:
        import qiskit  # noqa: F401
        return qiskit
    except ImportError as e:
        raise ImportError(
            "IBMQExperiment submission requires qiskit; it is not installed "
            "in this environment.  Staging and result ingestion still work "
            "without it.") from e


class IBMQExperiment(object):
    """Container pairing an ExperimentDesign with IBM Q submission state
    (reference: ibmqexperiment.py).  Lifecycle:
      1. exp = IBMQExperiment(edesign, pspec)
      2. exp.transpile()          (requires qiskit)
      3. exp.submit(backend)      (requires qiskit)
      4. exp.monitor() / exp.retrieve_results()
      5. data = exp.data          (ProtocolData with a DataSet)
    Results can also be ingested offline from counts dictionaries via
    `add_counts_from_dict`.
    """

    def __init__(self, edesign, pspec=None, remove_duplicates=True,
                 randomized_order=True, circuits_per_batch=75,
                 num_shots=1024, seed=None):
        self.edesign = edesign
        self.processor_spec = pspec
        self.remove_duplicates = remove_duplicates
        self.randomized_order = randomized_order
        self.circuits_per_batch = circuits_per_batch
        self.num_shots = num_shots
        self.seed = seed

        circuits = list(edesign.all_circuits_needing_data)
        if remove_duplicates:
            seen = set()
            circuits = [c for c in circuits
                        if not (c in seen or seen.add(c))]
        if randomized_order:
            rng = np.random.RandomState(seed)
            order = rng.permutation(len(circuits))
            circuits = [circuits[i] for i in order]
        self.pygsti_circuits = circuits
        self.pygsti_circuit_batches = [
            circuits[i:i + circuits_per_batch]
            for i in range(0, len(circuits), circuits_per_batch)]
        self.qiskit_circuit_batches = None
        self.qjobs = []
        self.job_ids = []
        self.batch_results = [None] * len(self.pygsti_circuit_batches)
        self.data = None

    # -- qiskit-dependent steps ---------------------------------------------

    def transpile(self, backend=None, opt_level=0):
        qiskit = _require_qiskit()
        from qiskit import QuantumCircuit, transpile
        self.qiskit_circuit_batches = []
        for batch in self.pygsti_circuit_batches:
            qk_batch = []
            for c in batch:
                qk_batch.append(self._to_qiskit(c, QuantumCircuit))
            if backend is not None:
                qk_batch = transpile(qk_batch, backend,
                                     optimization_level=opt_level)
            self.qiskit_circuit_batches.append(qk_batch)

    def _to_qiskit(self, circuit, QuantumCircuit):
        n = len(circuit.line_labels)
        qidx = {q: i for i, q in enumerate(circuit.line_labels)}
        qc = QuantumCircuit(n, n)
        for i in range(circuit.depth):
            lbl = circuit.layertup[i]
            comps = lbl.components if not lbl.is_simple else (lbl,)
            for g in comps:
                qs = [qidx[q] for q in (g.sslbls or ())]
                name = g.name
                if name == 'Gu3':
                    qc.u(*(float(a) for a in g.args), qs[0])
                elif name in ('Gxpi2',):
                    qc.sx(qs[0])
                elif name in ('Gcnot',):
                    qc.cx(qs[0], qs[1])
                elif name in ('Gcphase', 'Gcz'):
                    qc.cz(qs[0], qs[1])
                elif name in ('Gzr',):
                    qc.rz(float(g.args[0]), qs[0])
                elif name in ('Gi', 'Gdelay', '{idle}'):
                    pass
                else:
                    raise ValueError("No qiskit mapping for gate %s" % name)
        qc.measure(range(n), range(n))
        return qc

    def submit(self, backend, wait_time=1):
        """Submit all transpiled batches; `wait_time` seconds elapse between
        consecutive submissions (reference ibmqexperiment.submit's
        rate-limit pacing)."""
        import time as _time
        _require_qiskit()
        if self.qiskit_circuit_batches is None:
            raise RuntimeError("transpile() first")
        for k, batch in enumerate(self.qiskit_circuit_batches):
            if k > 0 and wait_time:
                _time.sleep(wait_time)
            job = backend.run(batch, shots=self.num_shots)
            self.qjobs.append(job)
            self.job_ids.append(job.job_id())

    def monitor(self):
        return [j.status() for j in self.qjobs]

    def retrieve_results(self):
        for k, job in enumerate(self.qjobs):
            self.batch_results[k] = job.result().get_counts()
        return self._build_data()

    # -- offline ingestion ----------------------------------------------------

    def add_counts_from_dict(self, counts_by_circuit):
        """Ingest {circuit: {bitstring: count}} results directly (offline
        path; no qiskit required)."""
        ds = DataSet()
        for c in self.pygsti_circuits:
            counts = counts_by_circuit.get(c)
            if counts is None:
                continue
            # qiskit bitstrings are little-endian; reverse to match
            ds.add_count_dict(c, {k[::-1]: v for k, v in counts.items()})
        ds.done_adding_data()
        self.data = ProtocolData(self.edesign, ds)
        return self.data

    def _build_data(self):
        counts_by_circuit = {}
        for batch, results in zip(self.pygsti_circuit_batches,
                                  self.batch_results):
            if results is None:
                continue
            if isinstance(results, dict):
                results = [results]
            for c, counts in zip(batch, results):
                counts_by_circuit[c] = counts
        return self.add_counts_from_dict(counts_by_circuit)

    # -- checkpointing --------------------------------------------------------

    def write(self, dirname):
        p = pathlib.Path(dirname)
        p.mkdir(parents=True, exist_ok=True)
        meta = {'job_ids': self.job_ids, 'num_shots': self.num_shots,
                'circuits_per_batch': self.circuits_per_batch,
                'seed': self.seed,
                'circuit_order': [c.str for c in self.pygsti_circuits]}
        with open(p / 'ibmqexperiment.json', 'w') as f:
            json.dump(meta, f, indent=2)
        self.edesign.write(dirname)

    @classmethod
    def from_dir(cls, dirname, edesign=None):
        """The experiment `write` put under `dirname`, with its circuits in
        the order they were staged and its job ids."""
        p = pathlib.Path(dirname)
        with open(p / 'ibmqexperiment.json') as f:
            meta = json.load(f)
        if edesign is None:
            from pygsti_tpu_torch.protocols.protocol import ExperimentDesign
            edesign = ExperimentDesign.from_dir(dirname)
        exp = cls(edesign, num_shots=meta['num_shots'],
                  circuits_per_batch=meta['circuits_per_batch'],
                  randomized_order=False, seed=meta.get('seed'))
        # the order the batches were staged in, so that results retrieved
        # for the jobs are matched to their circuits (the JAX package
        # re-batches in the design's order: ROADMAP.md section 3)
        by_str = {c.str: c for c in exp.pygsti_circuits}
        exp.pygsti_circuits = [by_str[s] for s in meta['circuit_order']]
        exp.pygsti_circuit_batches = [
            exp.pygsti_circuits[i:i + exp.circuits_per_batch]
            for i in range(0, len(exp.pygsti_circuits), exp.circuits_per_batch)]
        exp.job_ids = meta['job_ids']
        return exp
