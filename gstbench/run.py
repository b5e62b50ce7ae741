"""Run one cell of the benchmark once, on the card this process is started on:

    python3 gstbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds BENCHMARK.json, gstbench/ and the
program (pygsti_tpu_torch/).  Set-up reads the cell's design, builds the
truth's probabilities with the plain reference, the program's start model
and one warm request; then the window runs fits back to back for
`--seconds` (a fit that starts inside it runs whole).  With --trace 1 a
CUDA-only torch.profiler spans the window and the per-layer metrics are
reported; with --trace 0 the end-to-end ones (the profiler then spans the
window only where one of those reads the device trace).  After the window the plain
reference checks a sample of the window's fits drawn from the seed
(check.py).  The last line of standard output is the result (JSON); the
last lines of standard error are the numbers compared with their limits.

It exits non-zero with no result when there is no CUDA card (or fewer
than the cell asks for), when the program is not beside it, or when a
module of JAX or of the JAX package is loaded once the window has closed.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# top-level module names that no run may load
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'pygsti_tpu')
# host threads of the process, and the CPUs it is held to
THREADS = 1
CPUS = 2


def forbidden_modules():
    """The forbidden top-level names among the loaded modules (whole names:
    'pygsti_tpu_torch' is not 'pygsti_tpu')."""
    return sorted({m.split('.')[0] for m in list(sys.modules)} & set(FORBIDDEN))


def set_environment(root):
    """Caches at fixed paths inside the checkout; one host thread for
    torch's and the BLAS libraries' pools."""
    cache = os.path.join(root, 'gstbench', '.cache')
    for var, sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                     ('TRITON_CACHE_DIR', 'triton'), ('CUDA_CACHE_PATH', 'cuda')):
        os.environ[var] = os.path.join(cache, sub)
    for var in ('OMP_NUM_THREADS', 'MKL_NUM_THREADS', 'OPENBLAS_NUM_THREADS'):
        os.environ[var] = str(THREADS)


def hold_cpus():
    """Hold this process to the last CPUS of the CPUs it may run on, so
    that its dispatching thread is not moved between cores (its own
    affinity only)."""
    cpus = sorted(os.sched_getaffinity(0))
    if len(cpus) > CPUS:
        os.sched_setaffinity(0, set(cpus[-CPUS:]))


def import_program(root):
    import pygsti_tpu_torch
    where = os.path.abspath(pygsti_tpu_torch.__file__)
    if not where.startswith(os.path.join(os.path.abspath(root), '')):
        raise SystemExit("pygsti_tpu_torch was loaded from %s, not from this checkout" % where)
    return pygsti_tpu_torch


def fit_record(rec):
    """A fit's record for the metric readers (no tensors)."""
    return {k: rec[k] for k in ('index', 'stages', 'objfn_build_s', 'end_s') if k in rec}


def run_cell(cell, seed, seconds, trace, device, t_start, log=None):
    """One run of `cell`; returns (result dict, check lines).  The caller
    has checked the device."""
    import numpy as np
    import torch
    from gstbench import check, trace as _trace
    from gstbench.traffic import WARM, Generator, timed_window

    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    device = torch.device(device)
    import_program(cell.root)
    t_import = time.perf_counter() - t_start
    gen = Generator(cell, device, seed)
    t_gen = time.perf_counter() - t_start
    warm = gen.request(WARM, maxiter=cell.traffic['warm_lm_maxiter'])
    if warm['k1'] != cell.config['op_stack']:
        raise SystemExit("the program's op stack has %d slots with the identity; the "
                         "configuration states %d" % (warm['k1'], cell.config['op_stack']))
    del warm
    if device.type == 'cuda':
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    # the window is traced in a --trace 1 run, and in any run whose
    # end-to-end metrics read the device trace
    traced = trace or any(m['source'] == 'device_trace' for m, _ in cell.metrics('end_to_end'))
    log("set-up %.3f s (imports %.3f s, design, models and the truth %.3f s, warm request "
        "%.3f s); window of %s s%s" % (setup_s, t_import, t_gen - t_import, setup_s - t_gen,
                                       seconds, ' traced' if traced else ''))
    tr = _trace.DeviceTrace() if traced else None
    if tr is not None:
        tr.start()
    recs, window_s = timed_window(gen, seconds)
    trace_summary = None
    if tr is not None:
        tr.stop()
        t0 = time.perf_counter()
        trace_summary = _trace.summary(tr.events(), tr.window_s)
        del tr
        log("trace read in %.1f s: %d device events" % (time.perf_counter() - t0,
                                                       trace_summary['events']))
    peak = torch.cuda.max_memory_allocated(device) if device.type == 'cuda' else 0
    ends = [0.0] + [r['end_s'] for r in recs]
    log("window %.3f s: %d fits, %s LM iterations, %s s" % (
        window_s, len(recs), [sum(s['iterations'] for s in r['stages']) for r in recs],
        [round(b - a, 3) for a, b in zip(ends, ends[1:])]))

    record = {
        'setup_s': setup_s, 'window_s': window_s, 'fits': [fit_record(r) for r in recs],
        'trace': trace_summary, 'config': cell.config,
        'list_depths': [gen.design['depths'][:e] for e in gen.design['list_ends']],
        'outcomes': len(gen.outcomes)}
    metrics = {}
    for m, reader in cell.metrics('per_layer' if trace else 'end_to_end'):
        v = reader.read(record)
        if v is not None:
            metrics[m['name']] = {'value': float(v), 'unit': m['unit']}

    # the check: a sample of the window's fits drawn from the seed
    rng = np.random.default_rng(int(seed))
    n_check = min(int(cell.traffic['checked_fits']), len(recs))
    picked = sorted(int(i) for i in rng.choice(len(recs), n_check, replace=False))
    for r in recs:
        if r['index'] not in picked:
            r.pop('counts'), r.pop('dataset')
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    per_fit = []
    t0 = time.perf_counter()
    for i in picked:
        per_fit.append(check.numbers(gen, recs[i]))
    correct, compared = check.judge(per_fit, cell.limits)
    failed = sum(1 for n in per_fit if any(n[k] > cell.limits[k] for k in check.NUMBERS))
    log("check of fits %s in %.1f s" % (picked, time.perf_counter() - t0))

    dev = {'platform': 'gpu' if device.type == 'cuda' else device.type,
           'kind': torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu',
           'count': int(cell.workload['chips']), 'memory_peak_bytes': int(peak)}
    result = {'correct': correct, 'attempted': len(recs), 'failed': failed,
              'metrics': metrics, 'device': dev}
    if trace:
        dev['busy_s'] = trace_summary['busy_s']
        dev['window_s'] = trace_summary['window_s']
        result['breakdown'] = {'device_ops': trace_summary['device_ops'],
                               'idle_gaps': trace_summary['idle_gaps']}
    result['checks'] = compared
    lines = ["check %s %.6g limit %.6g" % (k, v['value'], v['limit'])
             for k, v in compared.items()]
    return result, lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_environment(ROOT)
    from gstbench.spec import Cell
    cell = Cell(args.workload, ROOT)
    import torch
    chips = int(cell.workload['chips'])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("gstbench: the cell needs %d CUDA card(s); torch.cuda.is_available() is %s, "
              "device_count() %d" % (chips, torch.cuda.is_available(),
                                     torch.cuda.device_count() if torch.cuda.is_available()
                                     else 0), file=sys.stderr)
        return 2
    torch.set_num_threads(THREADS)
    hold_cpus()
    result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace), 'cuda', T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print("gstbench: modules %s were loaded in this process" % bad, file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
