"""A throwaway checkout for the CPU tests: BENCHMARK.json and gstbench/
copied, the program linked, and the tiny fixtures added as new files."""

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
FIXTURES = os.path.join(HERE, 'fixtures')
TINY = 'tiny_cell'


def make(tmp, with_tiny=True):
    """A checkout under `tmp`; with `with_tiny` it also holds the tiny
    1-qubit cell (configuration smq1q_xyi_full, traffic tiny_gst, limits
    tiny), added only as new files and entries."""
    root = os.path.join(str(tmp), 'checkout')
    shutil.copytree(BENCH, os.path.join(root, 'gstbench'),
                    ignore=shutil.ignore_patterns('__pycache__', '.cache'))
    os.symlink(os.path.join(ROOT, 'pygsti_tpu_torch'), os.path.join(root, 'pygsti_tpu_torch'))
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as fh:
        bench = json.load(fh)
    if with_tiny:
        g = os.path.join(root, 'gstbench')
        shutil.copy(os.path.join(FIXTURES, 'smq1q_xyi_full.json'), os.path.join(g, 'configs'))
        shutil.copy(os.path.join(g, 'configs', 'smq2q_xyicnot_full.py'),
                    os.path.join(g, 'configs', 'smq1q_xyi_full.py'))
        shutil.copy(os.path.join(FIXTURES, 'tiny_gst.json'), os.path.join(g, 'traffic'))
        shutil.copy(os.path.join(FIXTURES, 'tiny.json'), os.path.join(g, 'limits', TINY + '.json'))
        bench['configs'].append({'name': 'smq1q_xyi_full', 'source': 'test fixture',
                                 'file': 'gstbench/configs/smq1q_xyi_full.json',
                                 'reduced': [], 'why': 'test fixture'})
        bench['workloads'].append({'name': TINY, 'config': 'smq1q_xyi_full',
                                   'traffic': 'tiny_gst', 'chips': 1, 'why': 'test fixture'})
        for m in bench['end_to_end'] + bench['per_layer']:
            if m['name'] in ('fit_s', 'lm_iters.gst2q', 'objfn_build_s.gst2q'):
                m['workloads'].append(TINY)
    with open(os.path.join(root, 'BENCHMARK.json'), 'w') as fh:
        json.dump(bench, fh, indent=1)
    return root


def write_tiny_design(root):
    """Write the tiny configuration's design with the design writer."""
    import subprocess
    import sys
    subprocess.run([sys.executable, os.path.join(root, 'gstbench', 'designs', 'write_designs.py'),
                    'smq1q_xyi_full'], check=True, cwd=root, capture_output=True, timeout=600)


def run_python(root, code, timeout=900):
    """Run `code` in a fresh interpreter with the checkout `root` first on
    its path (so its gstbench/ is the one imported); returns the process."""
    import subprocess
    import sys
    prelude = "import sys; sys.path.insert(0, %r)\n" % root
    env = dict(os.environ, OMP_NUM_THREADS='2')
    return subprocess.run([sys.executable, '-c', prelude + code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=timeout)


def last_json(proc):
    """The JSON object on the last line of a process's standard output."""
    lines = [l for l in proc.stdout.splitlines() if l.strip()]
    if proc.returncode != 0 or not lines:
        raise AssertionError("rc %d\n%s\n%s" % (proc.returncode, proc.stdout[-3000:],
                                                proc.stderr[-3000:]))
    return json.loads(lines[-1])
