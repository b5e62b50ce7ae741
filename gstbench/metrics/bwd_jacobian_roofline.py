"""bwd_jacobian_roofline: the least time the card could take for the blocked
Jacobians the window's LM iterations needed (one per iteration, over the
circuits of that stage's list, each at its own depth: arith.py), over the
device time of the traced `bwd_*` kernel launches, in percent."""

from gstbench import arith


def read(rec):
    tr = rec['trace']
    if tr is None or not tr['kernel_s']:
        return None
    cfg = rec['config']
    least = 0.0
    per_list = {}
    for f in rec['fits']:
        for s in f['stages']:
            i = s['list']
            if i not in per_list:
                per_list[i] = arith.jacobian_min_seconds(
                    rec['list_depths'][i], cfg['dim'], cfg['op_stack'], rec['outcomes'])
            least += s['iterations'] * per_list[i]
    return 100.0 * least / tr['kernel_s']
