"""The port's spans share the clock of torch.profiler's device trace, on a
card.

A span wraps a few launches of a distinctive kernel and a synchronize(); in
a CUDA-only trace of the same process the kernel's device intervals and
their runtime launch events lie inside the span, and the span ends within
100 us of the last device end.  Runs in a fresh process: on an H100 host
a profiler session late in a long process can record no device activity
at all.  Imports nothing of JAX:
    python -m pytest tests/test_torch_tracing_cuda.py --noconftest -q -rP
"""

import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r'''
import json
import torch
from pygsti_tpu_torch.baseobjs.profiler import span, tracing

x = torch.randn(1024, 1024, dtype=torch.float64, device='cuda')
torch.cumsum(x, dim=0)
torch.cuda.synchronize()
prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
prof.start()
with tracing() as rec:
    with span('scan'):
        for _ in range(5):
            torch.cumsum(x, dim=0)
        torch.cuda.synchronize()
prof.stop()
cuda = torch.autograd.DeviceType.CUDA
events = [(e.device_type() == cuda, e.name(), e.start_ns(), e.duration_ns(), e.correlation_id())
          for e in prof.profiler.kineto_results.events()]
s = rec.spans()
kern = [e for e in events if e[0] and 'scan' in e[1]]
corr = {e[4] for e in kern}
launch = [e for e in events if not e[0] and e[4] in corr and e[1] == 'cudaLaunchKernel']
print(json.dumps({'span': [s['start'][0], s['end'][0]],
                  'device': [[e[2], e[2] + e[3]] for e in kern],
                  'launch': [[e[2], e[2] + e[3]] for e in launch]}))
'''


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_spans_share_the_device_trace_clock(card):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get('PYTHONPATH', ''))
    out = subprocess.run([sys.executable, '-c', PROBE], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    s0, s1 = got['span']
    device, launch = got['device'], got['launch']
    assert len(device) == 5 and len(launch) == 5
    last = max(e for _, e in device)
    print("span %.1f us; launches at +%s us; kernels end at +%s us; span end - last device "
          "end %.1f us" % ((s1 - s0) / 1e3, [round((a - s0) / 1e3, 1) for a, _ in launch],
                          [round((e - s0) / 1e3, 1) for _, e in device], (s1 - last) / 1e3))
    assert all(s0 <= a and b <= s1 for a, b in device)
    assert all(s0 <= a and b <= s1 for a, b in launch)
    assert abs(s1 - last) < 100_000
