"""The harness finds a cell's configuration, traffic mix, limits and
metrics by name; a later change adds each as new files and entries, with
no file that is there edited."""

import hashlib
import json
import os
import shutil

from gstbench import spec
from gstbench.tests import checkout


def digests(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, 'gstbench')):
        for f in files:
            if '__pycache__' in d:
                continue
            p = os.path.join(d, f)
            with open(p, 'rb') as fh:
                out[os.path.relpath(p, root)] = hashlib.sha1(fh.read()).hexdigest()
    return out


def test_the_cells_of_the_benchmark_resolve():
    for w in spec.load_json(os.path.join(checkout.ROOT, 'BENCHMARK.json'))['workloads']:
        cell = spec.Cell(w['name'])
        assert cell.config['name'] == w['config']
        assert callable(cell.config_module.reference) and callable(cell.config_module.start_model)
        assert set(cell.limits) == {'prob_gap', 'value_gap', 'grad_gap', 'decrement'}
        for kind in ('end_to_end', 'per_layer'):
            names = [m['name'] for m, reader in cell.metrics(kind)]
            assert names, (w['name'], kind)
            assert all(callable(reader.read) for _, reader in cell.metrics(kind))
        assert 'setup_s' in [m['name'] for m, _ in cell.metrics('end_to_end')]


def test_a_metric_without_a_reader_of_its_own_takes_its_stem():
    assert spec.metric_reader('launches_per_step.qutrit').__name__.endswith('launches_per_step')


def test_new_configuration_traffic_and_metric_are_new_files(tmp_path):
    root = checkout.make(tmp_path)
    checkout.write_tiny_design(root)
    before = digests(root)
    g = os.path.join(root, 'gstbench')
    # a configuration, a traffic mix, limits and a metric, each a new file
    cfg = spec.load_json(os.path.join(g, 'configs', 'smq1q_xyi_full.json'))
    cfg.update(name='smq1q_xyi_dummy', design='gstbench/designs/smq1q_xyi_dummy.json')
    with open(os.path.join(g, 'configs', 'smq1q_xyi_dummy.json'), 'w') as fh:
        json.dump(cfg, fh)
    shutil.copy(os.path.join(g, 'configs', 'smq1q_xyi_full.py'),
                os.path.join(g, 'configs', 'smq1q_xyi_dummy.py'))
    shutil.copy(os.path.join(g, 'designs', 'smq1q_xyi_full.json'),
                os.path.join(g, 'designs', 'smq1q_xyi_dummy.json'))
    mix = spec.load_json(os.path.join(g, 'traffic', 'tiny_gst.json'))
    mix.update(lm_maxiter=50, checked_fits=1)
    with open(os.path.join(g, 'traffic', 'dummy_mix.json'), 'w') as fh:
        json.dump(mix, fh)
    shutil.copy(os.path.join(g, 'limits', 'tiny_cell.json'),
                os.path.join(g, 'limits', 'dummy_cell.json'))
    with open(os.path.join(g, 'metrics', 'fits_run.py'), 'w') as fh:
        fh.write('def read(rec):\n    return float(len(rec["fits"]))\n')
    added = set(digests(root)) - set(before)
    assert digests(root).items() >= before.items()          # nothing there was edited
    assert len(added) == 6
    # and their entries in BENCHMARK.json
    with open(os.path.join(root, 'BENCHMARK.json')) as fh:
        bench = json.load(fh)
    bench['configs'].append({'name': 'smq1q_xyi_dummy', 'source': 'test',
                             'file': 'gstbench/configs/smq1q_xyi_dummy.json', 'reduced': [],
                             'why': 'test'})
    bench['workloads'].append({'name': 'dummy_cell', 'config': 'smq1q_xyi_dummy',
                               'traffic': 'dummy_mix', 'chips': 1, 'why': 'test'})
    bench['end_to_end'].append({'name': 'fits_run', 'unit': 'fits', 'better': 'higher',
                                'bound': 0.1, 'source': 'host_clock',
                                'workloads': ['dummy_cell']})
    with open(os.path.join(root, 'BENCHMARK.json'), 'w') as fh:
        json.dump(bench, fh)
    proc = checkout.run_python(root, """
import json, time
from gstbench import run, spec
cell = spec.Cell('dummy_cell', sys.path[0])
res, lines = run.run_cell(cell, 2**31 + 17, 0.5, False, 'cpu', time.perf_counter(),
                          log=lambda *a: None)
print(json.dumps(res))
""")
    res = checkout.last_json(proc)
    assert res['correct'] is True
    assert set(res['metrics']) == {'setup_s', 'fits_run'}
    assert res['metrics']['fits_run']['value'] == res['attempted'] >= 1
