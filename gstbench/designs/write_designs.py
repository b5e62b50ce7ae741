"""Write a configuration's circuit design file once, from the program's own
design construction:

    python3 gstbench/designs/write_designs.py <config name> [--device cpu|cuda] [--out PATH]

It builds the circuits with the configuration module's `design_circuits`,
writes them in design.py's format to the configuration's `design` path
(or to PATH),
reads the file back and checks that it gives the same circuits, the
configuration's count and largest depth.
"""

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from gstbench import design as _design  # noqa: E402
from gstbench import spec  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('config')
    ap.add_argument('--device', default='cpu')
    ap.add_argument('--out', default=None)
    args = ap.parse_args()
    path = os.path.join(HERE, '..', 'configs', args.config)
    cfg = spec.load_json(path + '.json')
    mod = spec.load_module(path + '.py', 'config')
    t0 = time.time()
    circuits, list_ends = mod.design_circuits(cfg, args.device)
    seconds = time.time() - t0
    d = _design.from_port_circuits(
        circuits, list_ends, "gstbench/designs/write_designs.py %s --device %s (%.1f s)"
        % (args.config, args.device, seconds))
    out = args.out or os.path.join(ROOT, cfg['design'])
    _design.write(out, d)
    back = _design.load(out)
    if _design.port_circuits(back) != list(circuits):
        raise SystemExit("the design file does not read back to the same circuits")
    _design.check(back, cfg)
    print("%s: %d circuits, depth up to %d, %d distinct layers, lists %s, in %.1f s; %d bytes"
          % (out, len(circuits), max(back['depths']), len(back['layers']), list_ends, seconds,
             os.path.getsize(out)))


if __name__ == '__main__':
    main()
