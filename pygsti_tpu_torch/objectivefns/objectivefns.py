"""Objective functions and the blocked Jacobian, in torch (counterpart of
pygsti_tpu/objectivefns/objectivefns.py: the chi2 and Poisson-picture logL
raw functions, their switched forms, ObjectiveFunctionBuilder,
TimeIndependentMDCObjectiveFunction and the 'blocked' Jacobian).

The objective evaluates, on one device:
  fn(v)      -> objective value
  lsvec(v)   -> least-squares residual vector [n_elements]
  jtj_jtf(v) -> (lsvec, J^T J, J^T lsvec), what the LM optimizer consumes,
with J = d lsvec / dv from the blocked Jacobian: circuits grouped into depth
buckets, a forward scan per bucket, the backward accumulation of
ops/bwd_jacobian.py, a per-bucket Gram, and one chain through
Tv = d tensors / d v.
"""

from __future__ import annotations

import numpy as np
import torch

from pygsti_tpu_torch import DTYPE
from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
from pygsti_tpu_torch.ops.bwd_jacobian import bwd_jacobian_accumulate

DEFAULT_MIN_PROB_CLIP = 1e-4
DEFAULT_RADIUS = 1e-4
DEFAULT_MIN_PROB_CLIP_FOR_WEIGHTING = 1e-4
# bytes of one Jacobian block (the JAX package's default budget)
JAC_BLOCK_BYTES = 256 * 1024 * 1024


# -- raw objectives -----------------------------------------------------------
# The formulas are those of the JAX package, which reproduces the reference
# pyGSTi's.  p: probabilities, c: counts, t: total counts, f: frequencies.

def _sw_chi2_lsvec(p, c, t, f, mpc):
    return (p - f) * torch.sqrt(t / torch.clamp(p, min=mpc))


def _sw_chi2_dlsvec(p, c, t, f, mpc):
    cp = torch.clamp(p, min=mpc)
    w = torch.sqrt(t / cp)
    dw = torch.where(p > mpc, -0.5 * torch.sqrt(t) / cp ** 1.5,
                     torch.zeros_like(p))
    return w + (p - f) * dw


def _sw_logl_terms(p, c, t, f, minp, radius):
    fnz = torch.where(c == 0, torch.ones_like(f), f)
    freq_term = c * (torch.log(fnz) - 1.0)
    pos = torch.where(p < minp, torch.full_like(p, minp), p)
    c0 = t - c / minp
    c1 = 0.5 * c / (minp ** 2)
    terms = freq_term - c * torch.log(pos) + t * pos
    terms = torch.where(terms < 0, torch.zeros_like(terms), terms)
    terms = torch.where(p < minp, terms + c0 * (p - minp) + c1 * (p - minp) ** 2,
                        terms)
    zf = t * torch.where(p >= radius, p,
                         (-1.0 / (3 * radius ** 2)) * p ** 3 + p ** 2 / radius
                         + radius / 3.0)
    return torch.where(c == 0, zf, terms)


def _sw_logl_dterms(p, c, t, f, minp, radius):
    pos = torch.where(p < minp, torch.full_like(p, minp), p)
    c0 = t - c / minp
    c1 = 0.5 * c / (minp ** 2)
    d = torch.where(p < minp, c0 + 2 * c1 * (p - minp), t - c / pos)
    zf = t * torch.where(p >= radius, torch.ones_like(p),
                         (-1.0 / radius ** 2) * p ** 2 + 2 * p / radius)
    return torch.where(c == 0, zf, d)


def _sw_logl_hterms(p, c, t, f, minp, radius):
    pos = torch.where(p < minp, torch.full_like(p, minp), p)
    c1 = 0.5 * c / (minp ** 2)
    d2 = torch.where(p < minp, 2 * c1, c / pos ** 2)
    zf = torch.where(p >= radius, torch.zeros_like(p),
                     t * ((-2.0 / radius ** 2) * p + 2.0 / radius))
    return torch.where(c == 0, zf, d2)


def _sw_logl_lsvec(p, c, t, f, minp, radius):
    return torch.sqrt(_sw_logl_terms(p, c, t, f, minp, radius))


def _sw_logl_dlsvec(p, c, t, f, minp, radius):
    """d sqrt(terms) / dp, stable near the per-element minimum: below the
    roundoff floor of the terms it switches to the exact quadratic-regime
    limit sqrt(h/2)*sign(dterms) (see the JAX package's
    RawPoissonPicDeltaLogLFunction.dlsvec)."""
    terms = _sw_logl_terms(p, c, t, f, minp, radius)
    dterms = _sw_logl_dterms(p, c, t, f, minp, radius)
    h = _sw_logl_hterms(p, c, t, f, minp, radius)
    eps = torch.finfo(p.dtype).eps
    noise_floor = 100.0 * eps * torch.clamp(t, min=1.0)
    lsvec = torch.sqrt(torch.clamp(terms, min=1e-300))
    std = 0.5 * dterms / torch.clamp(lsvec, min=1e-150)
    quad = torch.sqrt(torch.clamp(h, min=0.0) / 2.0) * torch.sign(dterms)
    return torch.where(terms < noise_floor, quad, std)


class RawChi2Function(object):
    """N(p-f)^2 / max(p, minp) with its signed square-root lsvec."""

    name = 'chi2'

    def __init__(self, regularization=None):
        self.min_prob_clip_for_weighting = DEFAULT_MIN_PROB_CLIP_FOR_WEIGHTING
        if regularization:
            self.set_regularization(**regularization)

    def set_regularization(self, min_prob_clip_for_weighting=None):
        self.min_prob_clip_for_weighting = (
            min_prob_clip_for_weighting if min_prob_clip_for_weighting is not None
            else DEFAULT_MIN_PROB_CLIP_FOR_WEIGHTING)

    def lsvec(self, p, c, t, f):
        return _sw_chi2_lsvec(p, c, t, f, self.min_prob_clip_for_weighting)

    def dlsvec(self, p, c, t, f):
        return _sw_chi2_dlsvec(p, c, t, f, self.min_prob_clip_for_weighting)

    def terms(self, p, c, t, f):
        return self.lsvec(p, c, t, f) ** 2

    def chi2k_distributed_qty(self, objective_function_value):
        return objective_function_value


class RawPoissonPicDeltaLogLFunction(object):
    """2*Delta(logL) in the Poisson picture, N*f*log(f/p) - N*(f-p), with the
    'minp' Taylor patch and the cubic zero-frequency terms."""

    name = 'logl'

    def __init__(self, regularization=None):
        self.min_p = DEFAULT_MIN_PROB_CLIP
        self.radius = DEFAULT_RADIUS
        if regularization:
            self.set_regularization(**regularization)

    def set_regularization(self, min_prob_clip=DEFAULT_MIN_PROB_CLIP,
                           radius=DEFAULT_RADIUS):
        self.min_p = min_prob_clip
        self.radius = radius

    def lsvec(self, p, c, t, f):
        return _sw_logl_lsvec(p, c, t, f, self.min_p, self.radius)

    def dlsvec(self, p, c, t, f):
        return _sw_logl_dlsvec(p, c, t, f, self.min_p, self.radius)

    def terms(self, p, c, t, f):
        return _sw_logl_terms(p, c, t, f, self.min_p, self.radius)

    def chi2k_distributed_qty(self, objective_function_value):
        return 2 * objective_function_value


class _SwitchedRaw(object):
    """chi2 (flag 0, regs[0] = min_prob_clip_for_weighting) or Poisson logL
    (flag 1, regs[1] = min_prob_clip, regs[2] = radius).  The JAX package
    traces the flag to share one compiled graph between GST stages; torch
    runs eagerly, so here the flag is a Python int and only the selected
    form is computed."""

    def lsvec(self, p, c, t, f, flag, regs):
        if flag == 0:
            return _sw_chi2_lsvec(p, c, t, f, regs[0])
        return _sw_logl_lsvec(p, c, t, f, regs[1], regs[2])

    def dlsvec(self, p, c, t, f, flag, regs):
        if flag == 0:
            return _sw_chi2_dlsvec(p, c, t, f, regs[0])
        return _sw_logl_dlsvec(p, c, t, f, regs[1], regs[2])

    def terms(self, p, c, t, f, flag, regs):
        if flag == 0:
            return _sw_chi2_lsvec(p, c, t, f, regs[0]) ** 2
        return _sw_logl_terms(p, c, t, f, regs[1], regs[2])


def _switch_config(raw):
    """(flag, regs) of a raw objective for _SwitchedRaw."""
    if type(raw) is RawChi2Function:
        return 0, (raw.min_prob_clip_for_weighting, 1e-4, 1e-4)
    if type(raw) is RawPoissonPicDeltaLogLFunction:
        return 1, (1e-4, raw.min_p, raw.radius)
    raise TypeError("unsupported raw objective %r" % type(raw).__name__)


_RAW_CLASSES = {'chi2': RawChi2Function, 'logl': RawPoissonPicDeltaLogLFunction,
                'dlogl': RawPoissonPicDeltaLogLFunction}


class ObjectiveFunctionBuilder(object):
    """Recipe for building an MDC objective: 'chi2' or 'logl'."""

    @classmethod
    def cast(cls, obj):
        if isinstance(obj, cls):
            return obj
        if obj is None:
            return cls('logl')
        if isinstance(obj, str):
            return cls(obj)
        if isinstance(obj, dict):
            return cls(**obj)
        raise ValueError("Cannot cast %r to ObjectiveFunctionBuilder" % (obj,))

    def __init__(self, name='logl', regularization=None, penalties=None):
        if name not in _RAW_CLASSES:
            raise ValueError("unsupported objective %r (the port has %s)"
                             % (name, sorted(_RAW_CLASSES)))
        if penalties:
            raise ValueError("objective penalties are not ported")
        self.name = name
        self.regularization = regularization or {}

    def build_raw(self):
        return _RAW_CLASSES[self.name](self.regularization)

    def build(self, model, dataset, circuits, device="cuda"):
        return TimeIndependentMDCObjectiveFunction(
            self.build_raw(), model, dataset, circuits, name=self.name,
            device=device)

    def build_from_store(self, mdc_store):
        return TimeIndependentMDCObjectiveFunction(
            self.build_raw(), mdc_store.model, mdc_store.dataset,
            mdc_store.circuits, name=self.name, layout=mdc_store.layout,
            device=mdc_store.device)


class ModelDatasetCircuitsStore(object):
    """Bundles model + dataset + circuits + layout on one device."""

    def __init__(self, model, dataset, circuits=None, device="cuda",
                 precomp_layout=None):
        self.model = model
        self.dataset = dataset
        self.device = device
        self.circuits = list(circuits) if circuits is not None else list(dataset.keys())
        self.layout = precomp_layout if precomp_layout is not None else \
            SimpleForwardSimulator(model, device).create_layout(self.circuits, dataset)


class TimeIndependentMDCObjectiveFunction(object):
    """Model + dataset + circuits objective on one device.

    With ``num_active_circuits`` the counts and totals of the layout's
    circuits beyond that prefix are zeroed: those elements then contribute
    nothing to any value or Jacobian row, so the stages of a nested GST fit
    share the final list's layout."""

    def __init__(self, raw_objfn, model, dataset, circuits, name=None,
                 layout=None, num_active_circuits=None, device="cuda"):
        self.raw_objfn = raw_objfn
        self.model = model
        self.dataset = dataset
        self.circuits = list(circuits)
        self.name = name or raw_objfn.name
        self.device = torch.device(device)
        sim = SimpleForwardSimulator(model, self.device)
        self.layout = layout if layout is not None else \
            sim.create_layout(self.circuits, dataset)
        counts, totals = self.layout.counts_arrays(dataset)
        if num_active_circuits is not None:
            cutoff = self.layout.element_slices[num_active_circuits - 1].stop \
                if num_active_circuits > 0 else 0
            counts[cutoff:] = 0
            totals[cutoff:] = 0
            self.num_active_elements = cutoff
        else:
            self.num_active_elements = self.layout.num_elements
        with np.errstate(invalid='ignore', divide='ignore'):
            freqs = np.where(totals > 0, counts / np.where(totals > 0, totals, 1.0), 0.0)
        self.counts, self.total_counts, self.freqs = counts, totals, freqs
        self._data = tuple(torch.as_tensor(a, dtype=DTYPE, device=self.device)
                           for a in (counts, totals, freqs))
        self._flag, self._regs = _switch_config(raw_objfn)
        self._fns = _objective_fns(model, self.layout, sim)

    def _v(self, paramvec):
        v = paramvec if paramvec is not None else self.model.to_vector()
        return torch.as_tensor(v, dtype=DTYPE, device=self.device)

    def _args(self):
        return self._data + (self._flag, self._regs)

    def fn(self, paramvec=None):
        return float(self._fns['fn'](self._v(paramvec), *self._args()))

    def lsvec(self, paramvec=None):
        return self._fns['lsvec'](self._v(paramvec), *self._args()).cpu().numpy()

    def dlsvec(self, paramvec=None):
        return self._fns['dlsvec'](self._v(paramvec), *self._args()).cpu().numpy()

    def jtj_jtf(self, paramvec=None):
        ls, jtj, jtf = self._fns['jtj_jtf'](self._v(paramvec), *self._args())
        return ls.cpu().numpy(), jtj.cpu().numpy(), jtf.cpu().numpy()

    def run_device_lm(self, x0, maxiter=100, tol=None, linesearch=None):
        """The Levenberg-Marquardt loop with every state tensor on the
        objective's device.  Returns (x, converged, msg, mu, nu, norm_f, f,
        iterations)."""
        from pygsti_tpu_torch.optimize.device_lm import make_device_lm, EXIT_MESSAGES
        tol = tol or {}
        linesearch = linesearch or {}
        args = self._args()
        lm_init, lm_run, lm_finalize = make_device_lm(
            lambda x: self._fns['jtj_jtf'](x, *args),
            lambda x: self._fns['lsvec'](x, *args),
            ls_beta=linesearch.get('beta', 0.25),
            ls_max_evals=linesearch.get('max_evals', 6),
            ls_kappa=linesearch.get('kappa', 1.0))
        maxdx = tol.get('maxdx', 1.0)
        tols = (tol.get('f', 1.0), tol.get('jac', 1e-6), tol.get('relf', 1e-6),
                tol.get('relx', 1e-8),
                (maxdx ** 2) * len(x0) if maxdx else float('inf'))
        state = lm_run(lm_init(self._v(x0)), maxiter, tols)
        x, f, norm_f, mu, nu, code, k = lm_finalize(state, maxiter)
        return (x, code in (1, 2, 3, 4, 5), EXIT_MESSAGES.get(code, "exit code %d" % code),
                mu, nu, norm_f, f, k)

    def chi2k_distributed_qty(self, objective_function_value):
        return self.raw_objfn.chi2k_distributed_qty(objective_function_value)

    @property
    def num_elements(self):
        return self.layout.num_elements


# -- CPTP / SPAM penalty pieces -------------------------------------------------
# (used by the gauge objective; the penalty rows of the fit's own objective
# are not ported)
_NEG_EIG_SQRT_SHIFT = 1e-6


class HermitianSpectralSum(torch.autograd.Function):
    """sum_i g(ev_i) over the eigenvalues of a Hermitian matrix [..., n, n]
    (one value per matrix of the batch), for g(x) = -min(x, 0) (`which` =
    'neg') or g(x) = |x| ('abs').  The backward is the first-order formula
    d = sum_i g'(ev_i) u_i^dag dA u_i, i.e. the gradient U diag(g') U^dag:
    the derivative of eigenvectors divides by eigenvalue gaps and is not
    finite at the degenerate spectra of rank-deficient Choi and density
    matrices, which is also why the JAX package writes these two by hand."""

    @staticmethod
    def forward(ctx, A, which):
        ev, U = torch.linalg.eigh(A)
        if which == 'neg':
            val, slopes = -torch.sum(torch.clamp(ev, max=0.0), dim=-1), -(ev < 0).to(ev.dtype)
        elif which == 'abs':
            val, slopes = torch.sum(torch.abs(ev), dim=-1), torch.sign(ev)
        else:
            raise ValueError("unknown spectral sum %r" % (which,))
        ctx.save_for_backward(U, slopes)
        return val

    @staticmethod
    def backward(ctx, grad_out):
        U, slopes = ctx.saved_tensors
        grad = (U * slopes[..., None, :].to(U.dtype)) @ U.conj().transpose(-1, -2)
        return grad_out[..., None, None] * grad, None


def _sum_neg_evals(A):
    """-sum of the negative eigenvalues of a Hermitian matrix (or of each
    of a batch), with a derivative that stays finite at degenerate
    eigenvalues."""
    return HermitianSpectralSum.apply(A, 'neg')


# -- the blocked Jacobian ------------------------------------------------------

def bucket_plan(layout, n_out, NT, device):
    """Depth-bucketed circuit blocks, cached on the layout per device.

    Circuits are sorted by depth and cut at the 50/75/90th depth
    percentiles; each bucket is scanned at its own padded depth, in blocks
    of at most JAC_BLOCK_BYTES of Jacobian (NT columns) padded to a multiple of 64 with identity ops
    and effect row 0 (padded rows get zero counts, so they add nothing).
    Returns (buckets, inv_perm): each bucket is a dict of device tensors
    plus its element indices; inv_perm puts the concatenated bucket
    residuals back in layout element order."""
    cache = layout.__dict__.setdefault('_bucket_plans', {})
    key = (str(device), n_out, NT)
    if key in cache:
        return cache[key]
    B, D = layout.op_indices.shape
    # rows per block: the JAX package's budget rule, never beyond the batch
    blk = min(max(64, JAC_BLOCK_BYTES
                  // (max(n_out, 1) * NT * torch.finfo(DTYPE).bits // 8)), B)
    depths = np.asarray(layout.depths)
    order = np.argsort(depths, kind='stable')
    if B < 256:
        edges = [D]
    else:
        qs = sorted({int(np.ceil(np.percentile(depths, p))) for p in (50, 75, 90)})
        edges = [e for e in qs if 0 < e < D] + [D]
    align = 64
    eff_rows_all = layout.elem_effect.reshape(B, n_out)
    buckets, elem_sorted = [], []
    lo = -1
    for e in edges:
        sel = order[(depths[order] > lo) & (depths[order] <= e)]
        lo = e
        Dk = max(int(e), 1)
        step = max(blk, align)
        for s in range(0, len(sel), step):
            rows = sel[s:s + step]
            nk = len(rows)
            nk_pad = -(-nk // align) * align
            op_b = np.full((nk_pad, Dk), layout.identity_index, np.int32)
            op_b[:nk] = layout.op_indices[rows][:, :Dk]
            prep_b = np.zeros(nk_pad, np.int64)
            prep_b[:nk] = layout.prep_index[rows]
            eff_b = np.zeros((nk_pad, n_out), np.int64)
            eff_b[:nk] = eff_rows_all[rows]
            elem_idx = (rows[:, None] * n_out + np.arange(n_out)).ravel()
            elem_sorted.append(elem_idx)
            buckets.append({
                'cols': torch.as_tensor(op_b, device=device),
                'cols64': torch.as_tensor(op_b, dtype=torch.int64, device=device),
                'prep': torch.as_tensor(prep_b, device=device),
                'eff': torch.as_tensor(eff_b, device=device),
                'elem_idx': torch.as_tensor(elem_idx, dtype=torch.int64, device=device),
                'nk': nk, 'nk_pad': nk_pad})
    inv_perm = torch.as_tensor(np.argsort(np.concatenate(elem_sorted)),
                               dtype=torch.int64, device=device)
    cache[key] = (buckets, inv_perm)
    return cache[key]


def _objective_fns(model, layout, sim):
    """The objective's functions of (v, counts, totals, freqs, flag, regs)
    for a uniform-outcome layout, with the blocked Jacobian."""
    B = layout.op_indices.shape[0]
    if not (B > 0 and layout.num_elements % B == 0 and layout.rows_uniform_n_out):
        raise NotImplementedError("the blocked Jacobian needs every circuit to "
                                  "have the same number of outcomes")
    raw = _SwitchedRaw()
    probs_fn = sim.probs_fn(layout)
    device = sim.device
    compute_flat = model.flat_tensors_fn()
    tensors_jacobian = model.flat_tensors_jacobian_fn()
    dim = model.dim
    n_out = layout.num_elements // B
    n_ops = len(model.op_keys)
    n_preps = len(model.prep_keys)
    n_eff = sum(model.povms[k].num_outcomes for k in model.povm_keys)
    NT = n_ops * dim * dim + n_preps * dim + n_eff * dim
    o_sz, p_sz = n_ops * dim * dim, n_preps * dim
    j_dtype = DTYPE
    buckets, inv_perm = bucket_plan(layout, n_out, NT, device)

    def block_probs_jac(tf, bk):
        """(probs [nb*n_out], Jt [nb*n_out, NT]) for one circuit block:
        forward scan stashing the state before each layer, then the
        backward accumulation kernel bins per-op gradients."""
        ops = tf[:o_sz].reshape(n_ops, dim, dim).to(j_dtype)
        preps = tf[o_sz:o_sz + p_sz].reshape(n_preps, dim).to(j_dtype)
        effects = tf[o_sz + p_sz:].reshape(n_eff, dim).to(j_dtype)
        eye = torch.eye(dim, dtype=j_dtype, device=device)[None]
        G = torch.cat([ops, eye], dim=0)                  # [K+1, d, d]
        cols64 = bk['cols64']
        nb, Dk = cols64.shape
        E = effects[bk['eff']]                            # [nb, n_out, d]
        F = torch.empty((nb, Dk, dim), dtype=j_dtype, device=device)
        S = preps[bk['prep']]                             # [nb, d]
        for t in range(Dk):
            F[:, t] = S
            S = torch.bmm(G[cols64[:, t]], S.unsqueeze(-1)).squeeze(-1)
        A, B_final = bwd_jacobian_accumulate(bk['cols'], G, E, F)
        p = torch.einsum('bni,bi->bn', E, S)
        J_ops = A[:, :, :n_ops].reshape(nb, n_out, o_sz)
        prep_oh = torch.nn.functional.one_hot(bk['prep'], n_preps).to(j_dtype)
        J_preps = torch.einsum('br,bnj->bnrj', prep_oh, B_final).reshape(nb, n_out, p_sz)
        eff_oh = torch.nn.functional.one_hot(bk['eff'], n_eff).to(j_dtype)
        J_eff = torch.einsum('bne,bj->bnej', eff_oh, S).reshape(nb, n_out, n_eff * dim)
        Jt = torch.cat([J_ops, J_preps, J_eff], dim=2)
        return p.reshape(-1), Jt.reshape(nb * n_out, NT)

    def bucket_data(bk, counts, totals, freqs):
        pad = (bk['nk_pad'] - bk['nk']) * n_out
        idx = bk['elem_idx']
        return tuple(torch.nn.functional.pad(a[idx], (0, pad))
                     for a in (counts, totals, freqs))

    def lsvec_fn(v, counts, totals, freqs, flag, regs):
        return raw.lsvec(probs_fn(v), counts, totals, freqs, flag, regs)

    def fn_fn(v, counts, totals, freqs, flag, regs):
        return raw.terms(probs_fn(v), counts, totals, freqs, flag, regs).sum()

    @torch.no_grad()
    def jtj_jtf_fn(v, counts, totals, freqs, flag, regs):
        tf = compute_flat(v)
        Tv = tensors_jacobian(v)                          # [NT, P]
        M = torch.zeros((NT, NT), dtype=v.dtype, device=device)
        q = torch.zeros(NT, dtype=v.dtype, device=device)
        ls_parts = []
        for bk in buckets:
            cb, tb, fb = bucket_data(bk, counts, totals, freqs)
            p, Jt = block_probs_jac(tf, bk)
            p = p.to(v.dtype)
            ls = raw.lsvec(p, cb, tb, fb, flag, regs)
            Jw = raw.dlsvec(p, cb, tb, fb, flag, regs).to(j_dtype)[:, None] * Jt
            # the per-bucket Gram runs at the Jacobian dtype, the sum across
            # buckets at the model dtype: float32 accumulation of the partial
            # Grams degraded LM convergence on the TPU (Nsigma 500 -> 1039)
            M += (Jw.T @ Jw).to(v.dtype)
            q += (Jw.T @ ls.to(j_dtype)).to(v.dtype)
            ls_parts.append(ls[:bk['nk'] * n_out])
        ls = torch.cat(ls_parts)[inv_perm]
        return ls, Tv.T @ (M @ Tv), Tv.T @ q

    @torch.no_grad()
    def dlsvec_fn(v, counts, totals, freqs, flag, regs):
        tf = compute_flat(v)
        Tv = tensors_jacobian(v).to(j_dtype)
        J_parts = []
        for bk in buckets:
            cb, tb, fb = bucket_data(bk, counts, totals, freqs)
            p, Jt = block_probs_jac(tf, bk)
            dls = raw.dlsvec(p.to(v.dtype), cb, tb, fb, flag, regs)
            Jb = ((dls.to(j_dtype)[:, None] * Jt) @ Tv).to(v.dtype)
            J_parts.append(Jb[:bk['nk'] * n_out])
        return torch.cat(J_parts, dim=0)[inv_perm]

    return {'lsvec': torch.no_grad()(lsvec_fn), 'fn': torch.no_grad()(fn_fn),
            'jtj_jtf': jtj_jtf_fn, 'dlsvec': dlsvec_fn}
