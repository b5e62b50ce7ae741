"""mfu: the Gauss-Newton work the window's LM iterations needed (per
iteration 2 E P^2 + 2 E P + P^3 / 3, E the elements of that stage's circuit
list, P the parameters), over the traced window's seconds times the card's
FP64 Tensor Core peak, in percent."""

from gstbench import arith


def read(rec):
    tr = rec['trace']
    if tr is None or not rec['fits']:
        return None
    P = rec['config']['num_params']
    nout = rec['outcomes']
    flops = 0.0
    for f in rec['fits']:
        for s in f['stages']:
            E = len(rec['list_depths'][s['list']]) * nout
            flops += s['iterations'] * arith.lm_step_flops(E, P)
    return 100.0 * flops / (tr['window_s'] * arith.PEAK_F64_TENSOR_FLOPS)
