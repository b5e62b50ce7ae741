"""What the benchmark loads: no JAX and not the JAX package, compared by
whole top-level module names ('pygsti_tpu_torch' begins with
'pygsti_tpu'), and a reference that takes nothing from the program."""

import ast
import os
import sys

from gstbench import run
from gstbench.tests import checkout

BENCH = checkout.BENCH
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'pygsti_tpu'}


def imported_names(path):
    """Top-level names of every module a Python file imports."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split('.')[0])
    return out


def python_files(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(d, f)


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    import types
    monkeypatch.setitem(sys.modules, 'pygsti_tpu_torchx', types.ModuleType('pygsti_tpu_torchx'))
    assert 'pygsti_tpu' not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, 'pygsti_tpu.tools', types.ModuleType('pygsti_tpu.tools'))
    assert 'pygsti_tpu' in run.forbidden_modules()


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in python_files(BENCH):
        assert not imported_names(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in python_files(os.path.join(BENCH, 'reference')):
        names = imported_names(path)
        assert not names & (FORBIDDEN | {'pygsti_tpu_torch'}), (path, names)
        assert names <= {'__future__', 'functools', 'itertools', 'math', 'numpy', 'torch',
                         'gstbench'}, (path, names)


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    root = checkout.make(tmp_path)
    checkout.write_tiny_design(root)
    proc = checkout.run_python(root, """
import json, time
from gstbench import run, spec
res, lines = run.run_cell(spec.Cell('tiny_cell', sys.path[0]), 3, 0.5, False, 'cpu',
                          time.perf_counter(), log=lambda *a: None)
print(json.dumps({'correct': res['correct'], 'loaded': sorted({m.split('.')[0] for m in sys.modules})}))
""")
    out = checkout.last_json(proc)
    assert out['correct'] is True
    assert 'pygsti_tpu_torch' in out['loaded']
    assert not set(out['loaded']) & FORBIDDEN
