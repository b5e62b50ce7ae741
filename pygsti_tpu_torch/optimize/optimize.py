"""General-purpose minimization wrappers, host scipy (counterpart of
pygsti_tpu/optimize/optimize.py).

`minimize` dispatches over scipy methods plus the reference's extras
(basinhopping, 'supersimplex' = restarted Nelder-Mead, 'swarm'/'evolve'
via scipy differential evolution).  Used by gauge optimization and
wildcard fitting when an LM shape doesn't apply.
"""

from __future__ import annotations

import numpy as np
import scipy.optimize as spo


class OptimizerResult(object):
    def __init__(self, x, fun, success=True, message=""):
        self.x = x
        self.fun = fun
        self.success = success
        self.message = message


def minimize(fn, x0, method='cg', callback=None, tol=1e-10, maxiter=1000000,
             maxfev=None, stopval=None, jac=None, verbosity=0, **addl_kwargs):
    """Minimize `fn` starting from x0 (reference: optimize.minimize:~40).

    method: any scipy.optimize.minimize method (case-insensitive), or
    'basinhopping', 'supersimplex' (restarted Nelder-Mead), or 'evolve'
    (differential evolution)."""
    m = method.lower()
    x0 = np.asarray(x0, dtype=float)
    if m == 'basinhopping':
        res = spo.basinhopping(
            fn, x0, niter=addl_kwargs.get('niter', 100),
            minimizer_kwargs={'method': 'L-BFGS-B', 'jac': jac})
        return OptimizerResult(res.x, float(res.fun), True,
                               str(getattr(res, 'message', '')))
    if m == 'supersimplex':
        x = x0
        best_f = float(fn(x0))
        for _ in range(addl_kwargs.get('num_restarts', 3)):
            res = spo.minimize(fn, x, method='Nelder-Mead',
                               options={'maxiter': maxiter, 'xatol': tol,
                                        'fatol': tol})
            x = res.x
            if stopval is not None and res.fun < stopval:
                break
            if abs(best_f - res.fun) < tol:
                best_f = float(res.fun)
                break
            best_f = float(res.fun)
        return OptimizerResult(x, best_f, True, "supersimplex finished")
    if m == 'customcg':
        # reference's custom conjugate-gradient maximizer (optimize.py:117
        # fmax_cg, customcg.py:21) applied to -fn; scipy's CG line search
        # replaces the reference's hand-rolled bounded line search
        res = spo.minimize(fn, x0, method='CG', jac=jac, tol=tol,
                           options={'maxiter': maxiter})
        return OptimizerResult(res.x, float(res.fun), bool(res.success),
                               str(res.message))
    if m in ('evolve', 'evolutionary'):
        bounds = addl_kwargs.get('bounds') or \
            [(xi - 1.0, xi + 1.0) for xi in x0]
        res = spo.differential_evolution(fn, bounds, tol=tol,
                                         maxiter=min(maxiter, 1000), seed=0)
        return OptimizerResult(res.x, float(res.fun), res.success, res.message)
    opts = {'maxiter': maxiter}
    if maxfev is not None:
        # scipy spells the function-evaluation cap differently per method:
        # 'maxfev' (Nelder-Mead, Powell), 'maxfun' (L-BFGS-B, TNC), and
        # COBYLA's 'maxiter' IS its evaluation count
        if m in ('nelder-mead', 'powell'):
            opts['maxfev'] = int(maxfev)
        elif m == 'cobyla':
            opts['maxiter'] = min(maxiter, int(maxfev))
        else:
            opts['maxfun'] = int(maxfev)
    res = spo.minimize(fn, x0, method=method, jac=jac, tol=tol,
                       callback=callback, options=opts)
    return OptimizerResult(res.x, float(res.fun), bool(res.success),
                           str(res.message))


def check_jac(f, x0, jac_to_check, eps=1e-7, tol=1e-5, err_type='rel'):
    """Forward-difference check of a Jacobian (reference:
    optimize.check_jac:775): len(x0) more calls of `f`.  Returns (err_sum,
    errs, fd_jac): `errs` lists (row, col, err) for every entry whose error
    exceeds `tol`, the largest first, as the reference does."""
    x0 = np.asarray(x0, dtype=float)
    f0 = np.asarray(f(x0))
    J = np.asarray(jac_to_check)
    fd = np.zeros(J.shape, dtype=float)
    for i in range(len(x0)):
        xp = x0.copy()
        xp[i] += eps
        fd[:, i] = (np.asarray(f(xp)) - f0) / eps
    diff = np.abs(J - fd)
    if err_type == 'rel':
        diff = diff / (np.abs(fd) + 1e-10)
    rows, cols = np.nonzero(diff > tol)
    errs = [(int(i), int(j), float(diff[i, j])) for i, j in zip(rows, cols)]
    errs.sort(key=lambda t: -t[2])
    return float(diff.sum()), errs, fd


def create_objfn_printer(obj_func, start_time=None):
    """Callback printing an objective function's value with elapsed time
    (reference: optimize.create_objfn_printer:684)."""
    import time as _time
    if start_time is None:
        start_time = _time.time()

    def print_obj_func(x, f=None, accepted=None):
        if f is not None and accepted is not None:
            print("%5ds %22.10f %s" % (_time.time() - start_time, f,
                                       'accepted' if accepted
                                       else 'not accepted'))
        else:
            result = obj_func(x)
            duration = _time.time() - start_time
            try:
                print("%5ds %22.10f" % (duration, result))
            except TypeError:
                print('%5ds %s' % (duration, result))
    return print_obj_func
