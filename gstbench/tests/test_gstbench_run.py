"""gstbench/run.py refuses to report where it cannot measure: without a
CUDA card, and in a checkout without the program."""

import os
import shutil
import subprocess
import sys

import pytest

from gstbench.tests import checkout


def run_py(root, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='', **(env_extra or {}))
    return subprocess.run([sys.executable, os.path.join(root, 'gstbench', 'run.py'),
                           '--workload', 'gst2q_full_boot', '--seed', '2147483653',
                           '--seconds', '1', '--trace', '0'],
                          cwd=root, env=env, capture_output=True, text=True, timeout=600)


def test_without_a_card_it_exits_with_an_error_and_no_result():
    proc = run_py(checkout.ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ''
    assert 'CUDA' in proc.stderr


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    root = str(tmp_path)
    shutil.copy(os.path.join(checkout.ROOT, 'BENCHMARK.json'), root)
    shutil.copytree(checkout.BENCH, os.path.join(root, 'gstbench'),
                    ignore=shutil.ignore_patterns('__pycache__', '.cache'))
    proc = run_py(root)
    assert proc.returncode != 0 and proc.stdout.strip() == ''
    # past the look for a card, the program is missing
    proc = checkout.run_python(root, """
import time
from gstbench import run, spec
run.run_cell(spec.Cell('gst2q_full_boot', sys.path[0]), 1, 1, False, 'cpu', time.perf_counter())
""")
    assert proc.returncode != 0 and 'pygsti_tpu_torch' in proc.stderr


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize('workload', ['gst2q_full_boot', 'cloud3q_hs_chi2'])
def test_a_short_run_on_the_card(card, workload):
    proc = subprocess.run([sys.executable, os.path.join(checkout.BENCH, 'run.py'), '--workload',
                           workload, '--seed', '2147483659', '--seconds', '1', '--trace', '0'],
                          cwd=checkout.ROOT, capture_output=True, text=True, timeout=600)
    res = checkout.last_json(proc)
    assert res['correct'] is True
    assert res['device']['platform'] == 'gpu' and res['device']['count'] == 1
    assert 'setup_s' in res['metrics'] and list(res)[-1] == 'checks'
