"""Readings that set the limits of a cell's check (check.py), many seeds in
one process:

    python3 gstbench/control.py --workload <name> --seeds 11,12,... [--fault F] [--out PATH]

For each seed it runs as many fits as a run checks (the mix's
`checked_fits`), each on its own resample, through the timed path, and
reads the check's numbers three ways: the program's; the control's, the
plain reference computed in float32 put in the program's place; and, for
the decrement, the first fit's start (what a fit that leaves its state
unchanged reads).  With --fault it plants that fault (faults.py) under
the program.  One JSON line per fit, then a summary line: the largest
reading of each number over the program's fits, the smallest over the
control's, and per seed the verdict of the harness's own comparison
(check.judge against the cell's limits) on the program's fits and on the
control's: the control's has to be false on every seed.  Runs on the card;
the CPU tests call `readings` at a small size.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(cell, seeds, device, fault=None, log=None):
    """[per-fit readings] and the summary, for `seeds`."""
    import contextlib
    import torch
    from gstbench import check, faults
    from gstbench.traffic import WARM, Generator

    log = log or (lambda line: print(line, flush=True))
    device = torch.device(device)
    gen = Generator(cell, device, seeds[0])
    gen.request(WARM, maxiter=cell.traffic['warm_lm_maxiter'])
    rows = []
    for seed in seeds:
        gen.seed = int(seed)
        for k in range(int(cell.traffic['checked_fits'])):
            t0 = time.perf_counter()
            with faults.planted(fault) if fault else contextlib.nullcontext():
                rec = gen.request(k)
                fit_s = time.perf_counter() - t0
                prog = check.numbers(gen, rec)
            row = {'seed': int(seed), 'fit': k, 'fit_s': fit_s,
                   'iterations': sum(s['iterations'] for s in rec['stages']),
                   'program': prog, 'control': check.numbers(gen, rec, control=True)}
            if k == 0:
                row['start_decrement'] = check.start_decrement(gen, rec)
            rows.append(row)
            log(json.dumps(row))
    def verdicts(side):
        return [check.judge([r[side] for r in rows if r['seed'] == int(seed)],
                            cell.limits)[0] for seed in seeds]

    summary = {'program_max': {n: max(r['program'][n] for r in rows) for n in check.NUMBERS},
               'control_min': {n: min(r['control'][n] for r in rows) for n in check.NUMBERS},
               'start_decrement_min': min(r['start_decrement'] for r in rows
                                          if 'start_decrement' in r),
               'program_correct': verdicts('program'), 'control_correct': verdicts('control'),
               'fault': fault, 'seeds': [int(s) for s in seeds]}
    return rows, summary


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--fault', default=None)
    ap.add_argument('--out', default=None)
    args = ap.parse_args()
    from gstbench.run import set_environment
    set_environment(ROOT)
    import torch
    from gstbench.spec import Cell
    if not torch.cuda.is_available():
        raise SystemExit("control.py runs on a CUDA card")
    cell = Cell(args.workload, ROOT)
    seeds = [int(s) for s in args.seeds.split(',')]
    rows, summary = readings(cell, seeds, 'cuda', args.fault)
    summary['card'] = torch.cuda.get_device_name(0)
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, 'w') as fh:
            for r in rows:
                fh.write(json.dumps(r) + '\n')
            fh.write(json.dumps(summary) + '\n')


if __name__ == '__main__':
    main()
