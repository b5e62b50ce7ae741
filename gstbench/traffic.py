"""The one generator of the benchmark's traffic: a closed loop of GST fits,
one client, each fit on a fresh parametric-bootstrap resample.

A mix (traffic/<name>.json) gives:
  request               'gst_run': GateSetTomography.run over the design's
                        nested lists (no gauge optimization, no checkpoints);
                        'fit_simple': run_gst_fit_simple over all circuits,
                        from a fresh copy of the start model
  shots                 counts per circuit of each resample
  iteration_objectives  the objectives fitted on every list ('gst_run')
  final_objectives      the objectives fitted last on the final list; the last
                        one is the objective the check compares
  lm_maxiter            the LM cap of every stage
  warm_lm_maxiter       the cap of the set-up's warm request
  checked_fits          how many of a run's fits the check compares

Resample k draws `shots` outcomes per circuit from the truth's
probabilities (computed by the plain reference) with a torch.Generator on
the device, seeded from (seed, k): the same seed gives the same counts.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from gstbench import design as _design
from gstbench.reference.objective import probabilities

WARM = -1                     # the request index of the set-up's warm request


def stream_seed(seed, k):
    """The generator seed of resample k of a run seeded `seed`."""
    return (int(seed) * 1000003 + (k + 7) * 7919) % (2 ** 63)


class Generator(object):
    """Set-up (design, models, the truth's probabilities) and requests of
    one cell."""

    def __init__(self, cell, device, seed):
        cfg, mix = cell.config, cell.traffic
        self.cfg, self.mix, self.device, self.seed = cfg, mix, device, int(seed)
        self.design = _design.load(os.path.join(cell.root, cfg['design']))
        _design.check(self.design, cfg)
        self.circuits = _design.port_circuits(self.design)
        self.lists = [self.circuits[:e] for e in self.design['list_ends']]
        self.seqs = _design.seqs_array(self.design)
        mod = cell.config_module
        self.ref = mod.reference(cfg)
        self.theta_truth = mod.truth(cfg, self.ref)
        const = self.ref.constants(self.design['layers'], torch.float64, device)
        with torch.no_grad():
            ops, rho, effects = self.ref.split(self.theta_truth.to(device), const)
            p = probabilities(ops, rho, effects, torch.as_tensor(self.seqs, device=device))
        # multinomial draws need a distribution: rounding may leave p at -1e-17
        self.truth_probs = torch.clamp(p, min=0.0)
        self.outcomes = self.ref.outcomes
        self.template = mod.start_model(cfg)
        if self.template.num_params != cfg['num_params'] or self.template.dim != cfg['dim']:
            raise SystemExit("the program's model has %d parameters and dimension %d; the "
                             "configuration states %d and %d"
                             % (self.template.num_params, self.template.dim,
                                cfg['num_params'], cfg['dim']))
        final = mix['final_objectives'][-1]
        self.check_kind = final['name']
        self.check_regs = dict(final.get('regularization', {}))

    # -- data -------------------------------------------------------------------
    def resample(self, k):
        """Counts [N, M] float64 on the device of resample k."""
        g = torch.Generator(device=self.device)
        g.manual_seed(stream_seed(self.seed, k))
        shots = int(self.mix['shots'])
        draws = torch.multinomial(self.truth_probs, shots, replacement=True, generator=g)
        counts = torch.zeros(self.truth_probs.shape, dtype=torch.float64, device=self.device)
        counts.scatter_add_(1, draws, torch.ones_like(draws, dtype=torch.float64))
        return counts

    def dataset(self, counts):
        """The program's DataSet of a resample."""
        from pygsti_tpu_torch.data.dataset import DataSet
        ds = DataSet(outcome_labels=self.outcomes)
        rows = counts.cpu().numpy().astype(np.int64).tolist()
        for c, row in zip(self.circuits, rows):
            ds.add_count_dict(c, dict(zip(self.outcomes, row)))
        return ds

    # -- requests -----------------------------------------------------------------
    def _builders(self, entries):
        from pygsti_tpu_torch.objectivefns.objectivefns import ObjectiveFunctionBuilder
        return [ObjectiveFunctionBuilder(e['name'], regularization=e.get('regularization'))
                for e in entries]

    def request(self, k, maxiter=None):
        """Resample k, then one fit.  Returns its record: the fitted
        parameters, the objective value the program reports for them, its
        stages (list index, objective, LM iterations), the seconds of the
        objective builds where the protocol times them, and the data."""
        maxiter = int(self.mix['lm_maxiter'] if maxiter is None else maxiter)
        counts = self.resample(k)
        ds = self.dataset(counts)
        kind = self.mix['request']
        if kind == 'gst_run':
            rec = self._gst_run(ds, maxiter)
        elif kind == 'fit_simple':
            rec = self._fit_simple(ds, maxiter)
        else:
            raise SystemExit("unknown request kind %r" % kind)
        rec.update(index=k, counts=counts, dataset=ds)
        return rec

    def _gst_run(self, ds, maxiter):
        from pygsti_tpu_torch.protocols.gst import (GateSetTomography, GateSetTomographyDesign,
                                                    GSTInitialModel, GSTObjFnBuilders)
        from pygsti_tpu_torch.protocols.protocol import ProtocolData
        builders = GSTObjFnBuilders(self._builders(self.mix['iteration_objectives']),
                                    self._builders(self.mix['final_objectives']))
        data = ProtocolData(GateSetTomographyDesign(self.template, self.lists), ds)
        gst = GateSetTomography(GSTInitialModel(model=self.template.copy()),
                                gaugeopt_suite=None, objfn_builders=builders,
                                optimizer={'maxiter': maxiter}, verbosity=0,
                                device=self.device)
        results = gst.run(data, disable_checkpointing=True)
        est = results.estimates[gst.name]
        stages = []
        names_it = [e['name'] for e in self.mix['iteration_objectives']]
        names_fin = [e['name'] for e in self.mix['final_objectives']]
        for i, rs in enumerate(est.parameters['optimizer_results']):
            names = names_it + (names_fin if i == len(self.lists) - 1 else [])
            for name, r in zip(names, rs):
                stages.append({'list': i, 'objective': name,
                               'iterations': int(r.optimizer_specific_qtys['iterations'])})
        timers = est.parameters['profiler']
        fitted = est.models['final iteration estimate']
        return {'theta': np.asarray(fitted.to_vector(), dtype=np.float64),
                'reported': float(est.parameters['final_objfn_value']),
                'stages': stages,
                'objfn_build_s': sum(v for key, v in timers.items()
                                     if key.endswith('objective build')),
                'k1': len(fitted.op_keys) + 1}

    def _fit_simple(self, ds, maxiter):
        from pygsti_tpu_torch.algorithms.core import run_gst_fit_simple
        model = self.template.copy()
        builder = self._builders(self.mix['final_objectives'])[-1]
        result, objective = run_gst_fit_simple(ds, model, self.circuits, {'maxiter': maxiter},
                                               builder, device=self.device)
        return {'theta': np.asarray(model.to_vector(), dtype=np.float64),
                'reported': float(result.chi2_k_distributed_qty),
                'stages': [{'list': len(self.lists) - 1, 'objective': builder.name,
                            'iterations': int(result.optimizer_specific_qtys['iterations'])}],
                'objfn_build_s': None,
                'k1': len(model.op_keys) + 1}

    def program_objective(self, rec):
        """The program's objective of a fit's last stage, built anew by the
        program's own builder on the fit's data and the final list."""
        builder = self._builders(self.mix['final_objectives'])[-1]
        model = self.template.copy()
        model.from_vector(rec['theta'])
        return builder.build(model, rec['dataset'], self.circuits, device=self.device)

    def theta_start(self):
        return np.asarray(self.template.to_vector(), dtype=np.float64)


def timed_window(gen, seconds):
    """Requests 0, 1, ... back to back; a request that starts before
    `seconds` have passed is run whole.  Returns (records, window seconds)."""
    recs = []
    t0 = time.perf_counter()
    k = 0
    while k == 0 or time.perf_counter() - t0 < seconds:
        rec = gen.request(k)
        if gen.device.type == 'cuda':
            torch.cuda.synchronize()
        rec['end_s'] = time.perf_counter() - t0
        recs.append(rec)
        k += 1
    return recs, time.perf_counter() - t0
