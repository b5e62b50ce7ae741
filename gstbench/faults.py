"""Faults planted under the program, to show that the check catches them.

Each is a context manager that patches the program in this process only:

  unchanged  every LM stage returns its starting state (and its value)
  half       every objective leaves out the second half of its elements
             (their counts and totals zeroed), so the fit takes the rest
  altered    each fitted parameter vector is altered where it is produced:
             its entry of largest magnitude (the one the fit found most
             clearly away from zero) moved by 1e-2, and the value the fit
             reports taken at the altered vector, so that only the fit's
             distance from the optimum (the check's decrement) shows it

A cell on one chip has no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

FAULTS = ('unchanged', 'half', 'altered')


@contextlib.contextmanager
def planted(name):
    from pygsti_tpu_torch.objectivefns import objectivefns as ofn
    from pygsti_tpu_torch.optimize import simplerlm
    cls = ofn.TimeIndependentMDCObjectiveFunction
    if name == 'unchanged':
        orig = cls.run_device_lm

        def run_device_lm(self, x0, *args, **kwargs):
            out = orig(self, x0, *args, **kwargs)
            f0 = self.lsvec(x0)
            return (np.asarray(x0),) + out[1:5] + (float(np.dot(f0, f0)), f0) + out[7:]
        target, attr, new = cls, 'run_device_lm', run_device_lm
    elif name == 'half':
        orig = cls.__init__

        def __init__(self, *args, **kwargs):
            orig(self, *args, **kwargs)
            cut = self.layout.element_slices[len(self.layout.element_slices) // 2].start
            for a in (self.counts, self.total_counts, self.freqs):
                a[cut:] = 0
            self._data = tuple(torch.as_tensor(a, dtype=t.dtype, device=t.device)
                               for a, t in zip((self.counts, self.total_counts, self.freqs),
                                               self._data))
        target, attr, new = cls, '__init__', __init__
    elif name == 'altered':
        orig = simplerlm.SimplerLMOptimizer.run

        def run(self, objective, *args, **kwargs):
            result = orig(self, objective, *args, **kwargs)
            v = np.array(objective.model.to_vector(), dtype=np.float64)
            v[int(np.argmax(np.abs(v)))] += 1e-2
            objective.model.from_vector(v)
            f = np.asarray(objective.lsvec(v))
            result.x = v
            result.chi2_k_distributed_qty = objective.chi2k_distributed_qty(
                float(np.sum(f[:objective.num_elements] ** 2)))
            return result
        target, attr, new = simplerlm.SimplerLMOptimizer, 'run', run
    else:
        raise ValueError("unknown fault %r (the faults are %s)" % (name, FAULTS))
    setattr(target, attr, new)
    try:
        yield
    finally:
        setattr(target, attr, orig)
