"""lm_iters: LM iterations of a fit, summed over its stages
(optimizer_specific_qtys['iterations']), averaged over the window's fits."""


def read(rec):
    fits = rec['fits']
    return sum(s['iterations'] for f in fits for s in f['stages']) / len(fits) if fits else None
