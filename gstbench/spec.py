"""Find a cell's parts by name: BENCHMARK.json at the checkout's root, and
under this folder one file (or pair) per configuration, traffic mix, cell
limit set and metric.

  configs/<config>.json   the configuration as run (BENCHMARK.json's `file`)
  configs/<config>.py     its program-side builders and plain reference
  traffic/<traffic>.json  the mix's parameters, read by traffic.py
  limits/<workload>.json  the limits of the cell's correctness numbers
  metrics/<metric>.py     the metric's reader, `read(record)`; a metric
                          'a.b' without a file of its own takes metrics/a.py
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell(object):
    """Everything BENCHMARK.json and this folder say about one workload."""

    def __init__(self, workload, root=ROOT):
        self.root = root
        self.bench = load_json(os.path.join(root, 'BENCHMARK.json'))
        cells = {w['name']: w for w in self.bench['workloads']}
        if workload not in cells:
            raise SystemExit("no workload %r in BENCHMARK.json (it has %s)"
                             % (workload, sorted(cells)))
        self.workload = cells[workload]
        self.name = workload
        configs = {c['name']: c for c in self.bench['configs']}
        entry = configs[self.workload['config']]
        self.config_file = os.path.join(root, entry['file'])
        self.config = load_json(self.config_file)
        self.config_module = load_module(self.config_file[:-len('.json')] + '.py',
                                         'gstbench_config_' + entry['name'])
        self.bench_dir = os.path.join(root, self.bench['paths'][0])
        self.traffic = load_json(os.path.join(self.bench_dir, 'traffic',
                                              self.workload['traffic'] + '.json'))
        self.limits = load_json(os.path.join(self.bench_dir, 'limits', workload + '.json'))

    def metrics(self, kind):
        """[(entry, reader module)] of the cell's `end_to_end` or `per_layer`
        metrics: each whose `workloads` names this cell, or that has none."""
        out = []
        for m in self.bench[kind]:
            if 'workloads' in m and self.name not in m['workloads']:
                continue
            out.append((m, metric_reader(m['name'], self.bench_dir)))
        return out


def metric_reader(name, bench_dir=HERE):
    for stem in (name, name.split('.')[0]):
        path = os.path.join(bench_dir, 'metrics', stem + '.py')
        if os.path.exists(path):
            return load_module(path, 'gstbench_metric_' + stem.replace('.', '_'))
    raise SystemExit("no reader for metric %r under %s"
                     % (name, os.path.join(bench_dir, 'metrics')))
