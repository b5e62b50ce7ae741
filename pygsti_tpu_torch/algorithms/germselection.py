"""Germ selection: find amplificationally-complete germ sets (counterpart of
pygsti_tpu/algorithms/germselection.py; reference:
pygsti/algorithms/germselection.py:59).

A germ set is amplificationally complete (AC) when the union of the germs'
*twirled derivatives* spans the non-gauge parameter directions: errors along
every non-gauge direction grow linearly with germ power L.  The twirled
derivative of germ product M(theta) keeps only the derivative components
that survive averaging under conjugation by M's eigenbasis (the large-L
limit of d(M^L)/dtheta / L).

The work is batched tensor work on `device` (default "cuda"):

- the product rule over a germ's layers, dM = sum_i (G_n..G_{i+1}) dG_i
  (G_{i-1}..G_1), chained through the model's Tv = d tensors / d theta, for
  every candidate germ of one length at once;
- the twirl V (mask * V^-1 dM V) V^-1 for all parameters and candidates in
  one einsum (``eig`` per candidate, on the host: a germ product is not
  symmetric, and [d, d] is small);
- the non-gauge projector from the finite differences of the parameter
  vector under every gauge generator, all S^-1 G S transforms at once;
- each greedy step scores every remaining candidate set with one batched
  ``eigvalsh`` of a [C, P, P] stack, chunked to GRAM_STACK_BYTES.

Scores are taken from the eigenvalues on the host in numpy, in the JAX
package's arithmetic, and the searches keep its candidate order, its strict
comparisons and its random draws.  On the CPU the eigenvalues come from
numpy's LAPACK, as in the JAX package.  A set that does not yet amplify
every direction scores by the reciprocals of eigenvalues at rounding level,
so which of several such sets wins is decided by rounding, in either
package (ROADMAP.md section 3).
"""

from __future__ import annotations

import itertools
import time

import numpy as np
import torch

from pygsti_tpu_torch.baseobjs.verbosityprinter import VerbosityPrinter
from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.tools.argchecks import check_unsupported as _check_unsupported_germsel

# bytes of one batched eigvalsh (or svdvals) stack; larger batches are chunked
GRAM_STACK_BYTES = 4 * 2 ** 30
# bytes of one batch of complex twirled derivatives [C, d, d, P]
TWIRL_BATCH_BYTES = 2 ** 30


def qubit_labels_of(model):
    """The model's qubit labels: its state space's, else those its
    operations name (sorted), else 0..n-1."""
    ss = getattr(model, 'state_space', None)
    if ss is not None and getattr(ss, 'qubit_labels', None) is not None:
        return tuple(ss.qubit_labels)
    seen = set()
    for lbl in model.operations.keys():
        seen.update(lbl.sslbls or ())
    if seen:
        return tuple(sorted(seen, key=lambda s: (str(type(s)), s)))
    return tuple(range(model.num_qubits or 1))


def eigvalsh(stack):
    """Ascending eigenvalues of a stack of symmetric matrices: numpy's LAPACK
    on the CPU (the JAX package's), torch's solver on a card."""
    if stack.device.type == 'cpu':
        return torch.from_numpy(np.linalg.eigvalsh(stack.numpy()))
    return torch.linalg.eigvalsh(stack)


def gram(stack):
    """R^T R of each matrix of a stack: on the CPU by numpy one matrix at a
    time (numpy's own product for R.T @ R, as the JAX package computes it)."""
    if stack.device.type == 'cpu':
        return torch.from_numpy(np.stack([r.T @ r for r in stack.numpy()]))
    return stack.transpose(1, 2) @ stack


def svd(stack):
    """Thin SVD (U, s, Vh) of a stack of matrices: numpy's LAPACK on the
    CPU, torch's solver on a card.  A complex singular vector's phase is
    the solver's choice, and the JAX package's pair sensitivities keep the
    real part of rows in those vectors' coordinates."""
    if stack.device.type == 'cpu':
        return tuple(torch.from_numpy(x) for x in np.linalg.svd(stack.numpy(),
                                                                full_matrices=False))
    return torch.linalg.svd(stack, full_matrices=False)


def svdvals(stack):
    """Descending singular values of a stack of matrices, as eigvalsh."""
    if stack.device.type == 'cpu':
        return torch.from_numpy(np.linalg.svd(stack.numpy(), compute_uv=False))
    return torch.linalg.svdvals(stack)


class _OpStack(object):
    """A model's op stack G [K, d, d] and its Jacobian dG [K, d, d, P] on a
    device, at the model's current parameters."""

    def __init__(self, model, device):
        self.device = torch.device(device)
        self._model = model
        self._v = torch.as_tensor(model.to_vector(), dtype=torch.float64, device=self.device)
        self.G = model.tensors_fn()(self._v).ops
        self.d, self.P = model.dim, self._v.shape[0]
        self.op_keys = list(model.op_keys)
        self._dG = None

    @property
    def dG(self):
        if self._dG is None:
            K, d = self.G.shape[0], self.d
            self._dG = self._model.flat_tensors_jacobian_fn()(self._v)[:K * d * d] \
                .reshape(K, d, d, -1)
        return self._dG

    def indices(self, circuit):
        return [self.op_keys.index(l) for l in circuit.layertup]

    def products(self, idx):
        """M [C, d, d] of germs given as op indices [C, n], the first layer
        applied first, and the prefix products R_j (layers before j)."""
        C, n = idx.shape
        Gs = self.G[idx]
        R = [torch.eye(self.d, dtype=self.G.dtype, device=self.device).expand(C, -1, -1)]
        for j in range(n):
            R.append(Gs[:, j] @ R[-1])
        return R[n], R[:n], Gs

    def products_and_jacobians(self, idx):
        """(M [C, d, d], dM/dtheta [C, d, d, P]) by the product rule."""
        C, n = idx.shape
        M, R, Gs = self.products(idx)
        L = [None] * n            # suffix products: layers after j
        if n:
            L[n - 1] = None
            for j in range(n - 2, -1, -1):
                L[j] = Gs[:, j + 1] if L[j + 1] is None else L[j + 1] @ Gs[:, j + 1]
        dM = torch.zeros((C, self.d, self.d, self.P), dtype=self.G.dtype, device=self.device)
        for j in range(n):
            X = self.dG[idx[:, j]]                                  # [C, d, d, P]
            if j:
                X = torch.einsum('cxyp,cyb->cxbp', X, R[j])
            if L[j] is not None:
                X = torch.einsum('cax,cxbp->cabp', L[j], X)
            dM += X
        return M, dM


def _by_length(stack, germs):
    """[(positions, idx LongTensor [C, n])] grouping `germs` by length."""
    groups = {}
    for pos, g in enumerate(germs):
        groups.setdefault(len(g.layertup), []).append(pos)
    out = []
    for n, poss in groups.items():
        idx = torch.as_tensor([stack.indices(germs[p]) for p in poss],
                              dtype=torch.int64, device=stack.device).reshape(len(poss), n)
        out.append((poss, idx))
    return out


def _twirl(M, dM, eps, stats=None):
    """V (mask * V^-1 dM V) V^-1 with mask_ij = |l_i - l_j| < eps, for every
    parameter: [C, d*d, P] complex."""
    C, d, _, P = dM.shape
    # C small [d, d] eigendecompositions: on the host, by LAPACK's geev on
    # every device, then moved to dM's device
    evals, V = (x.to(dM.device) for x in torch.linalg.eig(M.cpu()))
    Vinv = torch.linalg.inv(V)
    gaps = (evals[:, :, None] - evals[:, None, :]).abs()
    mask = (gaps < eps).to(V.dtype)
    if stats is not None:
        near = ((gaps >= eps / 10) & (gaps <= eps * 10)).flatten(1).any(dim=1)
        stats['near_eps_gap_candidates'] = stats.get('near_eps_gap_candidates', 0) \
            + int(near.sum())
        off = gaps.masked_fill(torch.eye(d, dtype=torch.bool, device=gaps.device), np.inf)
        stats['smallest_eig_gap'] = min(stats.get('smallest_eig_gap', np.inf),
                                        float(off[off >= eps].min()) if bool((off >= eps).any())
                                        else np.inf)
    dMc = dM.to(V.dtype)
    E = torch.einsum('cax,cxyp,cyb->cabp', Vinv, dMc, V) * mask[..., None]
    T = torch.einsum('cax,cxyp,cyb->cabp', V, E, Vinv)
    return T.reshape(C, d * d, P)


def _twirled_batches(stack, germs, eps, stats=None):
    """Yields (positions, T [C, d*d, P] complex) over `germs` in batches."""
    per = stack.d * stack.d * stack.P * 16 * 3
    cap = max(1, TWIRL_BATCH_BYTES // per)
    for poss, idx in _by_length(stack, germs):
        for a in range(0, len(poss), cap):
            M, dM = stack.products_and_jacobians(idx[a:a + cap])
            yield poss[a:a + cap], _twirl(M, dM, eps, stats)


def _projected_twirls(model, germs, proj, eps=1e-6, device="cuda", stack=None,
                      stats=None):
    """[C, 2*d*d, P] real: the rows of Re(T_g @ proj) over those of
    Im(T_g @ proj), for each germ in order."""
    stack = stack or _OpStack(model, device)
    projt = torch.as_tensor(proj, dtype=torch.float64, device=stack.device)
    d2 = stack.d * stack.d
    out = torch.empty((len(germs), 2 * d2, stack.P), dtype=torch.float64,
                      device=stack.device)
    for poss, T in _twirled_batches(stack, germs, eps, stats):
        pos = torch.as_tensor(poss, device=stack.device)
        out[pos] = torch.cat([T.real, T.imag], dim=1) @ projt
    return out


def twirled_deriv(model, germ, eps=1e-6, device="cuda"):
    """Twirled derivative of the germ product: dM/dtheta projected onto the
    commutant of M (only equal-eigenvalue projector blocks kept), the
    direction amplified by germ powers; [d*d, P] complex numpy."""
    stack = _OpStack(model, device)
    (_, T), = list(_twirled_batches(stack, [germ], eps))
    return T[0].cpu().numpy()


def _germ_product_and_jacobian(model, germ, device="cuda"):
    """Dense product M of the germ's ops and dM/dtheta [d*d, P], numpy."""
    stack = _OpStack(model, device)
    M, dM = stack.products_and_jacobians(
        torch.as_tensor([stack.indices(germ)], device=stack.device).reshape(1, -1))
    return M[0].cpu().numpy(), dM[0].reshape(stack.d * stack.d, -1).cpu().numpy()


# -- the non-gauge projector --------------------------------------------------

def _member_params_under(member, S, Sinv):
    """(new parameter vectors [n, np], valid [n]) of a member after each
    gauge transform S[k], computed as its transform_inplace computes them
    (the same products in the same order); None for a member family
    without such a rule."""
    from pygsti_tpu_torch.modelmembers import operations as _op, states as _st, povms as _pv
    n = S.shape[0]
    ok = torch.ones(n, dtype=torch.bool, device=S.device)
    t = type(member)
    if member.num_params == 0 and t in (_op.StaticArbitraryOp, _op.StaticUnitaryOp,
                                        _op.StaticStandardOp, _st.StaticState):
        return S.new_zeros((n, 0)), ok
    pv = torch.as_tensor(member.to_vector(), dtype=S.dtype, device=S.device)
    if t is _op.FullArbitraryOp:
        d = member._dim
        return ((Sinv @ pv.reshape(d, d)) @ S).reshape(n, -1), ok
    if t is _op.FullTPOp:
        d = member._dim
        mx = (Sinv @ torch.as_tensor(member.dense(), dtype=S.dtype, device=S.device)) @ S
        e0 = torch.zeros(d, dtype=S.dtype, device=S.device)
        e0[0] = 1.0
        ok = ((mx[:, 0] - e0).abs() <= 1e-6 + 1e-5 * e0.abs()).all(dim=1)
        return mx[:, 1:, :].reshape(n, -1), ok
    if t is _st.FullState:
        return (Sinv @ pv[:, None])[..., 0], ok
    if t is _st.TPState:
        first = member._first
        new = (Sinv @ torch.cat([pv.new_tensor([first]), pv])[:, None])[..., 0]
        ok = (new[:, 0] - first).abs() <= 1e-6 + 1e-5 * abs(first)
        return new[:, 1:], ok
    if t is _pv.UnconstrainedPOVM:
        return (pv.reshape(member.num_outcomes, member._dim) @ S).reshape(n, -1), ok
    if t is _pv.TPPOVM:
        return (pv.reshape(member.num_outcomes - 1, member._dim) @ S).reshape(n, -1), ok
    return None


def _gauge_directions(model, gg, device):
    """[P, n_kept] columns (theta(S_k) - theta) / 1e-7 over the gauge
    generators k whose transform the parameterization admits."""
    x0 = gg.initial_params()
    v0 = model.to_vector()
    eps = 1e-7
    els = []
    for k in range(gg.num_params):
        x = x0.copy()
        x[k] += eps
        els.append(gg.compute_element(x))
    dev = torch.device(device)
    S = torch.as_tensor(np.stack([np.asarray(e.transform_matrix) for e in els]),
                        dtype=torch.float64, device=dev)
    Sinv = torch.as_tensor(np.stack([np.asarray(e.transform_matrix_inverse) for e in els]),
                           dtype=torch.float64, device=dev)
    parts, ok = [], torch.ones(len(els), dtype=torch.bool, device=dev)
    for _, obj in model._iter_parameterized_objs():
        res = _member_params_under(obj, S, Sinv)
        if res is None:
            parts = None
            break
        parts.append(res[0])
        ok &= res[1]
    if parts is not None:
        V = torch.cat(parts, dim=1) if parts else S.new_zeros((len(els), 0))
        cols = (V - torch.as_tensor(v0, device=dev)) / eps
        return cols[ok].T.cpu().numpy()
    cols = []     # any other family: one model copy per generator
    for el in els:
        m = model.copy()
        try:
            m.transform_inplace(el)
        except AssertionError:
            continue
        cols.append((m.to_vector() - v0) / eps)
    return np.stack(cols, axis=1) if cols else np.zeros((len(v0), 0))


def _nongauge_projector(model, item_weights=None, device="cuda"):
    """Projector onto the non-gauge parameter directions: the complement of
    the column space of the gauge directions, numpy [P, P]."""
    from pygsti_tpu_torch.models.gaugegroup import default_gauge_group_for_model
    gg = default_gauge_group_for_model(model)
    if gg.num_params == 0:
        return np.eye(model.num_params)
    gauge_dirs = _gauge_directions(model, gg, device)
    if gauge_dirs.shape[1] == 0:
        return np.eye(model.num_params)
    q, r = np.linalg.qr(gauge_dirs)
    keep = np.abs(np.diag(r)) > 1e-7 * max(np.abs(np.diag(r)).max(), 1e-30)
    q = q[:, keep]
    return np.eye(model.num_params) - q @ q.T


# -- scoring ------------------------------------------------------------------

def _score_from_evals(evals, score_func, penalty):
    """(score, n_amp) of descending eigenvalues, as the JAX package scores."""
    safe = np.clip(evals, 1e-30, None)
    n_amp = int(np.sum(evals > 1e-10 * max(np.max(evals), 1e-30)))
    base = float(np.sum(1.0 / safe)) if score_func == 'all' else float(1.0 / safe[-1])
    return base + penalty, n_amp


class _GermScorer(object):
    """Scores germ lists by the top `n_nongauge` eigenvalues of the sum of
    their twirled-derivative Grams ('allJac') or by the singular values of
    their stacked compact factors ('compactEVD'), batched on the device."""

    def __init__(self, model, proj, n_nongauge, device="cuda", mode='allJac',
                 score_func='all', l1_penalty=0.0, op_penalty=0.0, eps=1e-6, stats=None):
        self.model, self.proj, self.n_nongauge = model, proj, int(n_nongauge)
        self.device = torch.device(device)
        self.mode, self.score_func, self.eps = mode, score_func, eps
        self.l1_penalty, self.op_penalty = l1_penalty, op_penalty
        self.stats = stats if stats is not None else {}
        self._stack = None
        self._slot = {}           # germ -> row of self._grams / self._factors
        self._grams = None        # [N, P, P]
        self._factors = []        # compact factors [rank, P]

    def _ensure(self, germs):
        new = [g for g in dict.fromkeys(germs) if g not in self._slot]
        if not new:
            return
        t0 = time.time()
        if self._stack is None:
            self._stack = _OpStack(self.model, self.device)
        if self.mode == 'compactEVD':
            for g, F in zip(new, _germ_compact_factors(self, new)):
                self._slot[g] = len(self._factors)
                self._factors.append(F)
        else:
            grams = _germ_grams(self, new)
            base = 0 if self._grams is None else self._grams.shape[0]
            self._grams = grams if self._grams is None else torch.cat([self._grams, grams])
            for i, g in enumerate(new):
                self._slot[g] = base + i
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        self.stats['jacobian_twirl_s'] = self.stats.get('jacobian_twirl_s', 0.0) \
            + time.time() - t0

    def gram_sum(self, germs):
        """sum_g Re(T_g^H T_g) over `germs` in order, [P, P] on the device."""
        self._ensure(germs)
        P = self.model.num_params
        out = torch.zeros((P, P), dtype=torch.float64, device=self.device)
        if self.mode == 'compactEVD':
            raise ValueError("gram_sum needs the 'allJac' Grams")
        for g in germs:
            out += self._grams[self._slot[g]]
        return out

    def top_evals(self, germ_lists):
        """[n_lists, n_nongauge] descending eigenvalues (numpy)."""
        lists = [list(gl) for gl in germ_lists]
        self._ensure([g for gl in lists for g in gl])
        t0 = time.time()
        P, n = self.model.num_params, self.n_nongauge
        out = np.zeros((len(lists), n))
        if self.mode == 'compactEVD':
            # stacked factors of equal row counts go through one svdvals
            # each; no zero padding, so each matrix is decomposed as alone
            rows = [sum(self._factors[self._slot[g]].shape[0] for g in gl) for gl in lists]
            by_rows = {}
            for i, r in enumerate(rows):
                by_rows.setdefault(r, []).append(i)
            for R, members in by_rows.items():
                cap = max(1, GRAM_STACK_BYTES // (max(R, 1) * P * 8 * 2))
                for a in range(0, len(members), cap):
                    part = members[a:a + cap]
                    if R == 0:
                        continue
                    F = torch.stack([torch.cat([self._factors[self._slot[g]]
                                                for g in lists[i]]) for i in part])
                    sv = svdvals(F).cpu().numpy()
                    self._note_peak(F)
                    for i, sv_i in zip(part, sv):
                        out[i, :min(len(sv_i), n)] = (sv_i ** 2)[:n]
        else:
            cap = max(1, GRAM_STACK_BYTES // (P * P * 8))
            for a in range(0, len(lists), cap):
                chunk = lists[a:a + cap]
                Jc = self._sum_stack(chunk)
                ev = eigvalsh(Jc).cpu().numpy()
                self._note_peak(Jc)
                out[a:a + len(chunk)] = ev[:, ::-1][:, :n]
                del Jc
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        self.stats['scoring_s'] = self.stats.get('scoring_s', 0.0) + time.time() - t0
        self.stats['sets_scored'] = self.stats.get('sets_scored', 0) + len(lists)
        return out

    def _sum_stack(self, lists):
        """Each list's Gram sum, summed germ by germ in list order (the JAX
        package's order): a shared first part is summed once."""
        P = self.model.num_params
        k = 0
        while all(len(gl) > k for gl in lists) and \
                all(gl[k] == lists[0][k] for gl in lists):
            k += 1
        base = torch.zeros((P, P), dtype=torch.float64, device=self.device)
        for g in lists[0][:k]:
            base += self._grams[self._slot[g]]
        Jc = base.expand(len(lists), P, P).clone()
        width = max(len(gl) for gl in lists) - k
        zero = self._grams.shape[0]
        for j in range(width):
            ids = torch.as_tensor([self._slot[gl[k + j]] if len(gl) > k + j else zero
                                   for gl in lists], device=self.device)
            present = ids != zero
            Jc[present] += self._grams[ids[present]]
        return Jc

    def _note_peak(self, t):
        self.stats['gram_stack_bytes'] = max(self.stats.get('gram_stack_bytes', 0),
                                             t.numel() * t.element_size())

    def _penalty(self, gl):
        return self.l1_penalty * len(gl) + self.op_penalty * sum(len(g.layertup) for g in gl)

    def score_many(self, germ_lists):
        """[(score, n_amp)] of each germ list."""
        lists = [list(gl) for gl in germ_lists]
        evs = self.top_evals(lists)
        out = []
        for gl, ev in zip(lists, evs):
            s, na = _score_from_evals(ev, self.score_func, self._penalty(gl))
            thr = 1e-10 * max(np.max(ev), 1e-30)
            pos = ev[ev > 0]
            if len(pos):
                m = float(np.min(np.abs(np.log10(pos / thr))))
                self.stats['n_amp_margin_decades'] = min(
                    self.stats.get('n_amp_margin_decades', np.inf), m)
            out.append((s, na))
        return out

    def __call__(self, germ_list):
        return self.score_many([germ_list])[0]


def _germ_grams(scorer, germs):
    """[C, P, P] Re(T_g^H T_g) of T_g = twirled_deriv(g) @ proj."""
    Tri = _projected_twirls(scorer.model, germs, scorer.proj, scorer.eps,
                            stack=scorer._stack, stats=scorer.stats)
    return Tri.transpose(1, 2) @ Tri


def _germ_compact_factors(scorer, germs):
    """Per germ: s[keep, None] * Vh[keep] of the SVD of Re(T_g @ proj),
    keeping s > 1e-10 s_max (the JAX package's compact factor)."""
    Tri = _projected_twirls(scorer.model, germs, scorer.proj, scorer.eps,
                            stack=scorer._stack, stats=scorer.stats)
    d2 = Tri.shape[1] // 2
    out = []
    for i in range(len(germs)):
        U, s, Vh = torch.linalg.svd(Tri[i, :d2], full_matrices=False)
        keep = s > 1e-10 * max(float(s[0]), 1e-30)
        out.append(s[keep, None] * Vh[keep])
    return out


def compute_composite_germ_set_score(model, germs, score_func='all', eps=1e-6,
                                     non_gauge_projector=None, device="cuda"):
    """Score a germ set: J_comp = sum_g Re(T_g^H T_g) projected onto the
    non-gauge space; 'all' = sum of inverse nonzero eigenvalues (lower is
    better), 'worst' = 1/smallest.  Returns (score, n_amplified, eigenvalues)."""
    proj = non_gauge_projector if non_gauge_projector is not None \
        else _nongauge_projector(model, device=device)
    n_nongauge = int(round(np.trace(proj)))
    scorer = _GermScorer(model, proj, n_nongauge, device, eps=eps)
    Jc = scorer.gram_sum(list(germs))
    evals = eigvalsh(Jc[None])[0].cpu().numpy()[::-1]
    nonzero = evals[:n_nongauge]
    n_amplified = int(np.sum(nonzero > 1e-10 * max(evals[0], 1e-30)))
    safe = np.clip(nonzero, 1e-30, None)
    score = float(np.sum(1.0 / safe)) if score_func == 'all' else float(1.0 / safe[-1])
    return score, n_amplified, evals


def _all_cyclic_germs(op_labels, max_len, lls):
    germs, seen = [], set()
    for L in range(1, max_len + 1):
        for combo in itertools.product(op_labels, repeat=L):
            key = _cyclic_canonical(combo)
            if key not in seen:
                seen.add(key)
                germs.append(Circuit(combo, lls))
    return germs


def max_amplified_directions(model, op_labels=None, max_len=3, eps=1e-6,
                             non_gauge_projector=None, device="cuda"):
    """The number of non-gauge directions amplifiable by ANY germ set: the
    rank of the union of twirled derivatives over all candidate germs up to
    `max_len` (directions outside it, e.g. SPAM's, no germ amplifies)."""
    proj = non_gauge_projector if non_gauge_projector is not None \
        else _nongauge_projector(model, device=device)
    if op_labels is None:
        op_labels = list(model.operations.keys())
    germs = _all_cyclic_germs(op_labels, max_len, qubit_labels_of(model))
    _, n_amp, _ = compute_composite_germ_set_score(model, germs, 'all', eps, proj, device)
    return n_amp


def test_germs_list_completeness(model, germs, score_func='all', threshold=1e6,
                                 eps=1e-6, device="cuda"):
    """amplified(germs) - amplified(saturating candidate set): >= 0 means
    the set amplifies every germ-amplifiable non-gauge direction."""
    proj = _nongauge_projector(model, device=device)
    n_max = max_amplified_directions(model, non_gauge_projector=proj, eps=eps, device=device)
    _, n_amp, _ = compute_composite_germ_set_score(model, germs, score_func, eps, proj, device)
    return n_amp - n_max


def _randomized(model, strength, seed):
    """A 1-qubit model rotated, any other depolarized, by at most `strength`."""
    return model.rotate(max_rotate=strength, seed=seed) if model.num_qubits == 1 \
        else model.depolarize(max_op_noise=strength, seed=seed)


def find_germs(target_model, randomize=True, randomization_strength=1e-2,
               num_gs_copies=1, seed=None, candidate_germ_counts=None,
               candidate_seed=None, force="singletons", algorithm='greedy',
               score_func='all', threshold=1e6, verbosity=1, mem_limit=None,
               assume_real=True, float_type=np.float64, mode='allJac',
               l1_penalty=1e-2, op_penalty=0.0, fixed_slack=None,
               slack_frac=None, device="cuda", stats=None):
    """Find an amplificationally-complete germ set by greedy selection from
    power-limited candidate circuits (reference: germselection.find_germs:59).

    `num_gs_copies`, `assume_real` and `float_type` are numeric-backend
    hints in the reference; this implementation scores with one model copy
    in real float64 arithmetic, and other requests raise.  `stats`, a dict,
    receives the candidate count, the greedy steps, the seconds of the
    Jacobian and twirl, the projector and the scoring, the largest stack
    scored at once, and the margins named in the module's docstring."""
    _check_unsupported_germsel('find_germs',
                               num_gs_copies=(num_gs_copies, (None, 1)),
                               assume_real=(assume_real, True),
                               float_type=(float_type, np.float64))
    stats = stats if stats is not None else {}
    printer = VerbosityPrinter.create_printer(verbosity)
    model = _randomized(target_model, randomization_strength, seed) if randomize \
        else target_model
    op_labels = list(model.operations.keys())
    lls = qubit_labels_of(model)

    if candidate_germ_counts is None:
        candidate_germ_counts = {3: 'all upto'}
    candidates, seen = [], set()
    rng = np.random.RandomState(candidate_seed)
    for length, count in candidate_germ_counts.items():
        if count == 'all upto':
            for L in range(1, length + 1):
                for combo in itertools.product(op_labels, repeat=L):
                    key = _cyclic_canonical(combo)
                    if key not in seen:
                        seen.add(key)
                        candidates.append(Circuit(combo, lls))
        else:
            for _ in range(count):
                combo = tuple(op_labels[rng.randint(len(op_labels))] for _ in range(length))
                key = _cyclic_canonical(combo)
                if key not in seen:
                    seen.add(key)
                    candidates.append(Circuit(combo, lls))
    stats['candidates'] = len(candidates)

    t0 = time.time()
    proj = _nongauge_projector(model, device=device)
    stats['projector_s'] = time.time() - t0
    scorer = _GermScorer(model, proj, int(round(np.trace(proj))), device, mode,
                         score_func, l1_penalty, op_penalty, stats=stats)
    # the completeness target: the directions THIS candidate pool amplifies
    if mode == 'compactEVD':
        n_nongauge = compute_composite_germ_set_score(model, candidates, score_func,
                                                      non_gauge_projector=proj,
                                                      device=device)[1]
    else:
        evals = eigvalsh(scorer.gram_sum(candidates)[None])[0].cpu().numpy()[::-1]
        n_nongauge = int(np.sum(evals[:scorer.n_nongauge]
                                > 1e-10 * max(evals[0], 1e-30)))
    stats['target_directions'] = n_nongauge
    scorer.n_nongauge = n_nongauge      # sets are scored on their top n_nongauge
    printer.log("Germ selection: %d candidates, %d amplifiable directions to cover"
                % (len(candidates), n_nongauge))

    germs = [Circuit((l,), lls) for l in op_labels] if force == "singletons" else []
    if algorithm == 'grasp':
        return _find_germs_grasp(candidates, germs, scorer, n_nongauge, threshold, printer,
                                 rand_state=np.random.RandomState(seed))
    if algorithm == 'slack':
        return _find_germs_integer_slack(candidates, germs, scorer, n_nongauge, threshold,
                                         printer, fixed_slack=fixed_slack,
                                         slack_frac=slack_frac)

    cur_score, n_amp = scorer(germs)
    steps = 0
    for _ in range(len(candidates)):
        if n_amp >= n_nongauge and cur_score < threshold:
            break
        rest = [c for c in candidates if c not in germs]
        if not rest:
            break
        best = None
        for cand, (s, na) in zip(rest, scorer.score_many([germs + [c] for c in rest])):
            if best is None or (na, -s) > (best[1], -best[2]):
                best = (cand, na, s)
        germs.append(best[0])
        steps += 1
        n_amp, cur_score = best[1], best[2]
        printer.log("  added germ %s -> %d/%d amplified, score %.3g"
                    % (best[0].str, n_amp, n_nongauge, cur_score), 2)
        if best[1] >= n_nongauge and cur_score < threshold:
            break
    stats['greedy_steps'] = steps
    stats['score'] = cur_score
    assert n_amp >= n_nongauge, \
        "Could not find an amplificationally complete germ set (%d/%d)" % (n_amp, n_nongauge)
    return germs


def _find_germs_grasp(candidates, forced, set_score, n_nongauge, threshold,
                      printer, iterations=5, alpha=0.5, rand_state=None):
    """GRASP germ search: randomized-greedy construction from a restricted
    candidate list + pruning local search, best of `iterations` restarts
    (reference: grasp.py:275 run_grasp_iteration; germselection GRASP
    mode).  Each construction step scores every candidate in one batch."""
    rng = rand_state if rand_state is not None else np.random.RandomState()
    best_solution = None

    def solution_quality(germs):
        s, na = set_score(germs)
        return (na, -len(germs), -s)

    for it in range(iterations):
        germs = list(forced)
        cur_score, n_amp = set_score(germs)
        while not (n_amp >= n_nongauge and cur_score < threshold):
            rest = [c for c in candidates if c not in germs]
            if not rest:
                break
            scored = [(c, na, sc) for c, (sc, na)
                      in zip(rest, set_score.score_many([germs + [c] for c in rest]))]
            best_na = max(x[1] for x in scored)
            top = [x for x in scored if x[1] == best_na]
            top.sort(key=lambda x: x[2])
            rcl = top[:max(1, int(np.ceil(alpha * len(top))))]
            pick = rcl[rng.randint(len(rcl))]
            germs.append(pick[0])
            n_amp, cur_score = pick[1], pick[2]
        if not (n_amp >= n_nongauge):
            continue

        base_s, _ = set_score(germs)
        improved = True
        while improved:
            improved = False
            for g in list(germs):
                if g in forced:
                    continue
                trial = [x for x in germs if x != g]
                s, na = set_score(trial)
                if na >= n_nongauge and s <= max(base_s * 1.1, threshold):
                    germs = trial
                    base_s = s
                    improved = True
        q = solution_quality(germs)
        if best_solution is None or q > best_solution[0]:
            best_solution = (q, list(germs))
        printer.log("  GRASP iter %d: %d germs (coverage %d/%d)"
                    % (it, len(germs), q[0], n_nongauge), 2)

    assert best_solution is not None, \
        "GRASP could not find an amplificationally complete germ set"
    return best_solution[1]


def _find_germs_integer_slack(candidates, forced, set_score, n_nongauge,
                              threshold, printer, fixed_slack=None,
                              slack_frac=None, max_iters=10000):
    """Integer-weight slack optimization (reference:
    germselection.optimize_integer_germs_slack): start from the FULL
    candidate set and repeatedly remove the element whose removal keeps the
    score within the current score + slack (slack = fixed_slack or
    slack_frac * score); every removal of one iteration scored in a batch."""
    if fixed_slack is None and slack_frac is None:
        slack_frac = 0.1
    germs = list(dict.fromkeys(list(forced) + list(candidates)))
    cur_score, n_amp = set_score(germs)
    assert n_amp >= n_nongauge, \
        "Candidate germ pool is not amplificationally complete (%d/%d)" % (n_amp, n_nongauge)
    for _ in range(max_iters):
        slack = fixed_slack if fixed_slack is not None else abs(cur_score) * slack_frac
        free = [g for g in germs if g not in forced]
        trials = [[x for x in germs if x != g] for g in free]
        best = None
        for g, (s, na) in zip(free, set_score.score_many(trials) if trials else []):
            if na >= n_nongauge and s <= cur_score + slack:
                if best is None or s < best[1]:
                    best = (g, s, na)
        if best is None:
            break
        germs.remove(best[0])
        cur_score = best[1]
        printer.log("  slack: removed %s -> %d germs (score %.3g)"
                    % (best[0].str, len(germs), cur_score), 2)
    return germs


def _cyclic_canonical(combo):
    """Canonical form under cyclic rotation (germs are cyclic)."""
    rots = [combo[i:] + combo[:i] for i in range(len(combo))]
    return min(rots)


# =============================================================================
# Reference-named public entry points (reference: germselection.py): each
# search strategy is one `algorithm=` mode of find_germs; these run them on
# explicit candidate lists.
# =============================================================================

def _make_set_score(model, score_func='all', op_penalty=0.0, l1_penalty=0.0, device="cuda"):
    """(set_score, n_target): the scoring find_germs uses, over an explicit
    germ list; n_target is the number of germ-AMPLIFIABLE directions."""
    proj = _nongauge_projector(model, device=device)
    n_nongauge = int(round(np.trace(proj)))
    n_target = max_amplified_directions(model, non_gauge_projector=proj, device=device)
    return _GermScorer(model, proj, n_nongauge, device, score_func=score_func,
                       l1_penalty=l1_penalty, op_penalty=op_penalty), n_target


def _first_model(model_list):
    return model_list[0] if isinstance(model_list, (list, tuple)) else model_list


def _forced_singletons(model, force):
    if force == "singletons":
        lls = qubit_labels_of(model)
        return [Circuit((gl,), lls) for gl in model.operations.keys()]
    return list(force) if isinstance(force, (list, tuple)) else []


def find_germs_breadthfirst(model_list, germs_list, randomize=False,
                            randomization_strength=1e-3, num_copies=None,
                            seed=0, op_penalty=0, score_func='all', tol=1e-6,
                            threshold=1e6, check=False, force="singletons",
                            verbosity=0, device="cuda", **_kwargs):
    """Greedy (breadth-first) germ selection from an explicit candidate list
    (reference: germselection.find_germs_breadthfirst)."""
    _check_unsupported_germsel('find_germs_breadthfirst',
                               num_copies=(num_copies, (None, 1)), check=(check, False))
    model = _first_model(model_list)
    if randomize:
        model = randomize_model_list([model], randomization_strength, 1, seed)[0]
    printer = VerbosityPrinter.create_printer(verbosity)
    set_score, n_nongauge = _make_set_score(model, score_func, op_penalty, device=device)
    germs = _forced_singletons(model, force)
    candidates = [c for c in germs_list if c not in germs]
    cur_score, n_amp = set_score(germs) if germs else (np.inf, 0)
    while candidates:
        if n_amp >= n_nongauge and cur_score < threshold:
            break
        best = None
        for cand, (sc, na) in zip(candidates,
                                  set_score.score_many([germs + [c] for c in candidates])):
            if best is None or (na, -sc) > (best[2], -best[1]):
                best = (cand, sc, na)
        germs.append(best[0])
        candidates.remove(best[0])
        cur_score, n_amp = best[1], best[2]
        printer.log("  added %s -> %d/%d" % (best[0].str, n_amp, n_nongauge), 2)
    return germs


find_germs_breadthfirst_greedy = find_germs_breadthfirst


def find_germs_depthfirst(model_list, germs_list, randomize=False,
                          randomization_strength=1e-3, num_copies=None,
                          seed=0, op_penalty=0, score_func='all', tol=1e-6,
                          threshold=1e6, check=False, force="singletons",
                          verbosity=0, device="cuda", **_kwargs):
    """Depth-first germ selection: add candidates in list order until the
    set is amplificationally complete (reference:
    germselection.find_germs_depthfirst)."""
    _check_unsupported_germsel('find_germs_depthfirst',
                               num_copies=(num_copies, (None, 1)), check=(check, False))
    model = _first_model(model_list)
    if randomize:
        model = randomize_model_list([model], randomization_strength, 1, seed)[0]
    set_score, n_nongauge = _make_set_score(model, score_func, op_penalty, device=device)
    germs = _forced_singletons(model, force)
    for cand in germs_list:
        if cand in germs:
            continue
        score, n_amp = set_score(germs)
        if n_amp >= n_nongauge and score < threshold:
            break
        germs.append(cand)
    return germs


def find_germs_grasp(model_list, germs_list, alpha=0.1, randomize=False,
                     randomization_strength=1e-3, num_copies=None, seed=0,
                     op_penalty=0, score_func='all', tol=1e-6, threshold=1e6,
                     force="singletons", iterations=5, verbosity=0,
                     return_all=False, device="cuda", **_kwargs):
    """GRASP germ search over an explicit candidate list (reference:
    germselection.find_germs_grasp)."""
    _check_unsupported_germsel('find_germs_grasp',
                               num_copies=(num_copies, (None, 1)),
                               return_all=(return_all, False))
    model = _first_model(model_list)
    if randomize:
        model = randomize_model_list([model], randomization_strength, 1, seed)[0]
    set_score, n_nongauge = _make_set_score(model, score_func, op_penalty, device=device)
    forced = _forced_singletons(model, force)
    return _find_germs_grasp(list(germs_list), forced, set_score, n_nongauge, threshold,
                             VerbosityPrinter.create_printer(verbosity),
                             iterations=iterations, alpha=alpha,
                             rand_state=np.random.RandomState(seed))


def find_germs_integer_slack(model_list, germs_list, randomize=False,
                             randomization_strength=1e-3, num_copies=None,
                             seed=0, l1_penalty=1e-2, op_penalty=0,
                             initial_weights=None, score_func='all',
                             max_iter=100, fixed_slack=False,
                             slack_frac=False, return_all=False, tol=1e-6,
                             check=False, force="singletons", verbosity=0,
                             device="cuda", **_kwargs):
    """Integer-weight slack-based germ optimization (reference:
    germselection.find_germs_integer_slack)."""
    _check_unsupported_germsel('find_germs_integer_slack',
                               num_copies=(num_copies, (None, 1)),
                               initial_weights=(initial_weights, None),
                               return_all=(return_all, False),
                               check=(check, False))
    model = _first_model(model_list)
    if randomize:
        model = randomize_model_list([model], randomization_strength, 1, seed)[0]
    set_score, n_nongauge = _make_set_score(model, score_func, op_penalty, l1_penalty,
                                            device=device)
    forced = _forced_singletons(model, force)
    return _find_germs_integer_slack(
        list(germs_list), forced, set_score, n_nongauge, threshold=1e6,
        printer=VerbosityPrinter.create_printer(verbosity),
        fixed_slack=fixed_slack or None,
        slack_frac=slack_frac or (None if fixed_slack else 0.1),
        max_iters=max_iter)


def compute_germ_set_score(germs, target_model=None, neighborhood=None,
                           neighborhood_size=5, randomization_strength=1e-2,
                           score_func='all', op_penalty=0.0, l1_penalty=0.0,
                           seed=None, device="cuda"):
    """Worst (max) composite score of a germ set over a neighborhood of
    randomized models (reference: germselection.compute_germ_set_score)."""
    if neighborhood is None:
        neighborhood = randomize_model_list([target_model], randomization_strength,
                                            neighborhood_size, seed)
    worst = -np.inf
    for m in neighborhood:
        set_score, _ = _make_set_score(m, score_func, op_penalty, l1_penalty, device=device)
        worst = max(worst, set_score(list(germs))[0])
    return worst


def test_germ_set_infl(model, germs_to_test, score_func='all', threshold=1e6,
                       device="cuda"):
    """Whether a germ set is amplificationally complete at infinite L
    (reference: germselection.test_germ_set_infl)."""
    return bool(test_germs_list_completeness(model, germs_to_test, score_func=score_func,
                                             threshold=threshold, device=device) >= 0)


def test_germ_set_finitel(model, germs_to_test, length, weights=None,
                          return_spectrum=False, tol=1e-6, device="cuda"):
    """Whether the germ set is amplificationally complete at FINITE length
    `length`: the derivatives of germ^(length//|germ|) products span the
    amplifiable directions (reference: germselection.test_germ_set_finitel)."""
    proj = _nongauge_projector(model, device=device)
    n_target = max_amplified_directions(model, non_gauge_projector=proj, device=device)
    stack = _OpStack(model, device)
    powers = [germ * max(int(length) // max(len(germ.layertup), 1), 1)
              for germ in germs_to_test]
    derivs = [None] * len(powers)
    for poss, idx in _by_length(stack, powers):
        _, dM = stack.products_and_jacobians(idx)
        for i, p in enumerate(poss):
            derivs[p] = dM[i].reshape(stack.d * stack.d, -1) \
                / max(len(powers[p].layertup), 1)
    if weights is None:
        weights = np.ones(len(derivs))
    projt = torch.as_tensor(proj, device=stack.device)
    gram = sum(float(w) * (dv @ projt).T @ (dv @ projt) for w, dv in zip(weights, derivs))
    spectrum = np.sort(eigvalsh(gram[None])[0].cpu().numpy())
    observable = spectrum[-n_target:] if n_target > 0 else spectrum
    ok = bool(observable[0] > tol)
    if return_spectrum:
        return ok, spectrum
    return ok


def randomize_model_list(model_list, randomization_strength, num_copies, seed=None):
    """Randomize each model (or make `num_copies` randomized copies of a
    single model) (reference: germselection.randomize_model_list)."""
    if not isinstance(model_list, (list, tuple)):
        model_list = [model_list]
    if len(model_list) > 1 and num_copies not in (None, 1):
        raise ValueError("Input multiple models XOR request multiple copies "
                         "of one model -- not both!")
    out = []
    for i, m in enumerate(model_list):
        for j in range(num_copies or 1):
            s = None if seed is None else seed + i * (num_copies or 1) + j
            out.append(m.depolarize(max_op_noise=randomization_strength, seed=s))
    return out


def drop_random_germs(candidate_list, rand_frac, target_model, keep_bare=True, seed=None):
    """Randomly drop a fraction of candidate germs, optionally keeping the
    bare single-gate germs (reference: germselection.drop_random_germs)."""
    rng = np.random.RandomState(seed)
    lls = qubit_labels_of(target_model)
    bare = {Circuit((gl,), lls) for gl in target_model.operations.keys()} \
        if keep_bare else set()
    return [c for c in candidate_list if c in bare or rng.rand() >= rand_frac]


def create_circuit_cache(model, circuits, device="cuda"):
    """{Circuit: dense product matrix (numpy)}, the products batched."""
    stack = _OpStack(model, device)
    circuits = list(circuits)
    prods = [None] * len(circuits)
    for poss, idx in _by_length(stack, circuits):
        M = stack.products(idx)[0].cpu().numpy()
        for i, p in enumerate(poss):
            prods[p] = M[i]
    return {c: prods[i] for i, c in enumerate(circuits)}


def clean_germ_list(model, circuit_cache, eq_thresh=1e-6):
    """Deduplicate candidate germs whose dense products coincide (reference:
    germselection.clean_germ_list).  Returns (deduped_circuits, deduped_cache)."""
    seen = []
    out_circuits, out_cache = [], {}
    for c, mx in circuit_cache.items():
        if any(np.linalg.norm(mx - m2) < eq_thresh for m2 in seen):
            continue
        seen.append(mx)
        out_circuits.append(c)
        out_cache[c] = mx
    return out_circuits, out_cache


# ---------------------------------------------------------------------------
# Compact-EVD / low-rank-update machinery for greedy germ + vector selection
# (reference: germselection.py:3255-5230).  Host-side numpy bookkeeping of
# the searches; the twirled derivatives come from the device.
# ---------------------------------------------------------------------------

def compact_EVD(mat, threshold=1e-10, assume_hermitian=False):  # noqa: N802
    """Compact eigenvalue decomposition: the nonzero eigenvalues e and
    eigenvector columns U of `mat` with U diag(e) U^H = mat (reference:
    germselection.compact_EVD:3255)."""
    if assume_hermitian:
        e, U = np.linalg.eigh((mat + mat.conj().T) / 2)
    else:
        e, U = np.linalg.eig(mat)
    keep = np.nonzero(np.abs(e) > threshold)[0]
    return e[keep], U[:, keep]


def compact_EVD_via_SVD(mat, threshold=1e-10):  # noqa: N802
    """Compact EVD of mat^H mat from the SVD of `mat` (reference:
    germselection.compact_EVD_via_SVD:3296)."""
    import scipy.linalg as _sla
    try:
        _, s, Vh = np.linalg.svd(mat)
    except np.linalg.LinAlgError:
        _, s, Vh = _sla.svd(mat, lapack_driver='gesvd')
    keep = np.nonzero(np.abs(s) > threshold)[0]
    return s[keep] ** 2, Vh.conj().T[:, keep]


def construct_update_cache(mat, evd_tol=1e-10):
    """(e, U, projU) for a run of symmetric low-rank updates to `mat`: the
    compact spectrum, eigenvectors, and I - U U^T (reference:
    germselection.construct_update_cache:3340)."""
    e, U = compact_EVD(mat, evd_tol, assume_hermitian=True)
    proj_U = np.eye(mat.shape[0]) - U @ U.T
    return e, U, proj_U


def _complement_basis(proj_U, update, tol):
    """Orthonormal basis P of the part of `update`'s column space outside
    the cached column space, via pivoted QR."""
    import scipy.linalg as _sla
    proj_update = proj_U @ update
    q, r, _ = _sla.qr(proj_update, mode='economic', pivoting=True)
    keep = np.nonzero(np.abs(np.diag(r)) > tol)[0]
    return q[:, keep], proj_update


def symmetric_low_rank_spectrum_update(update, orig_e, U, proj_U,
                                       force_rank_increase=False):
    """Spectrum of (mat + update @ update.T) from the update cache of mat in
    the subspace of U and the new directions (Brand's compact-SVD update).
    Returns (new_eigenvalues, rank_increased); (None, False) when the update
    adds no new directions (reference:
    germselection.symmetric_low_rank_spectrum_update:3383)."""
    P, proj_update = _complement_basis(proj_U, update, 1e-10)
    if P.shape[1] == 0:
        return None, False
    block_column = np.concatenate([U.T @ update, P.T @ proj_update], axis=0)
    K = block_column @ block_column.T
    K[np.arange(len(orig_e)), np.arange(len(orig_e))] += orig_e
    return np.linalg.eigvalsh(K), True


def minamide_style_inverse_trace(update, orig_e, U, proj_U, force_rank_increase=False):
    """Trace of pinv(mat + update @ update.T) by Minamide's pseudoinverse
    update on the cached compact EVD of mat.  Returns (updated_trace,
    updated_rank, rank_increased); (None, None, False) when
    `force_rank_increase` and the update lies inside the column space
    (reference: germselection.minamide_style_inverse_trace:3541)."""
    P, proj_update = _complement_basis(proj_U, update, 1e-9)
    rank_inc = P.shape[1]
    beta = U.T @ update
    e_inv = 1.0 / orig_e

    if rank_inc == 0:
        if force_rank_increase:
            return None, None, False
        X = e_inv[:, None] * beta
        central = np.linalg.inv(np.eye(beta.shape[1]) + beta.T @ X)
        drop = np.einsum('ij,jk,ik->i', X, central, X)
        return float(np.sum(e_inv) - np.sum(drop)), len(orig_e), False

    R_update = P.T @ proj_update
    try:
        pinv_R = np.linalg.pinv(R_update, rcond=1e-10)
    except np.linalg.LinAlgError:
        pinv_R = stable_pinv(R_update)
    gamma = pinv_R.T @ beta.T
    pinv_E_beta = e_inv[:, None] * beta
    B = np.eye(pinv_R.shape[0]) - pinv_R @ R_update
    Dinv = np.linalg.inv(np.eye(pinv_R.shape[0]) + B @ (pinv_E_beta.T @ pinv_E_beta) @ B)
    EbB = pinv_E_beta @ B
    upper_diag = np.einsum('ij,jk,ik->i', EbB, Dinv, EbB) + e_inv
    lower_right = gamma @ (e_inv[:, None] * gamma.T) + pinv_R.T @ pinv_R \
        - gamma @ EbB @ Dinv @ EbB.T @ gamma.T
    trace = float(np.sum(upper_diag) + np.trace(lower_right))
    return trace, len(orig_e) + rank_inc, True


def stable_pinv(mat):
    """Pseudoinverse via scipy's gesvd-driver SVD (reference:
    germselection.stable_pinv:4626)."""
    import scipy.linalg as _sla
    U, s, Vh = _sla.svd(mat, lapack_driver='gesvd', full_matrices=False)
    s_inv = np.where(s > 1e-10, 1.0 / np.where(s > 1e-10, s, 1.0), 0.0)
    return Vh.T @ (s_inv[:, None] * U.T)


def fast_kron(a, b):
    """Kronecker product via broadcasting (reference: germselection.fast_kron:4618)."""
    return (a[:, None, :, None] * b[None, :, None, :]).reshape(
        a.shape[0] * b.shape[0], a.shape[1] * b.shape[1])


def construct_update_cache_rank_one(mat, evd_tol=1e-10, prev_update_cache=None,
                                    rank_one_update=None):
    """(pinv_A, proj_A, trace(pinv_A), rank) for a run of rank-one
    pseudoinverse updates to `mat` (Meyer's update; reference:
    germselection.construct_update_cache_rank_one:5028)."""
    import scipy.linalg as _sla
    if prev_update_cache is not None and rank_one_update is not None:
        pinv_A, rank_increased = rank_one_psuedoinverse_update(
            rank_one_update, prev_update_cache[0], prev_update_cache[1])
        rank = prev_update_cache[3] + (1 if rank_increased else 0)
    else:
        try:
            pinv_A, rank = _sla.pinvh(mat, return_rank=True)
        except np.linalg.LinAlgError:
            pinv_A = stable_pinv(mat)
            rank = int(np.linalg.matrix_rank(mat, tol=evd_tol))
    proj_A = np.eye(mat.shape[0]) - mat @ pinv_A
    return pinv_A, proj_A, float(np.trace(pinv_A)), rank


def rank_one_inverse_trace_update(vector_update, pinv_A, proj_A, pinv_A_trace,
                                  force_rank_increase=False):
    """trace(pinv(A + v v^T)) from trace(pinv(A)) (reference:
    germselection.rank_one_inverse_trace_update:5096).  Returns
    (updated_trace, rank_increased)."""
    v_ = np.asarray(vector_update).reshape(-1)
    v = pinv_A @ v_
    beta = 1.0 + float(v_ @ v)
    w = proj_A @ v_
    norm_w = np.linalg.norm(w)
    if norm_w > 1e-10:
        G_diag = (-2.0 / norm_w ** 2) * (v * w) + (beta / norm_w ** 4) * (w ** 2)
        rank_increased = True
    elif beta > 1e-10:
        G_diag = (-beta / abs(beta) ** 2) * (v ** 2)
        rank_increased = False
    else:
        gamma = pinv_A @ v
        norm_v = np.linalg.norm(v)
        G_diag = (-2.0 / norm_v ** 2) * (gamma * v) + (float(v @ gamma) / norm_v ** 4) * (v ** 2)
        rank_increased = False
    return float(np.sum(G_diag) + pinv_A_trace), rank_increased


def rank_one_psuedoinverse_update(vector_update, pinv_A, proj_A, force_rank_increase=False):
    """pinv(A + v v^T) from pinv(A) (Meyer's update; reference:
    germselection.rank_one_psuedoinverse_update:5159).  Returns
    (updated_pinv, rank_increased)."""
    v_ = np.asarray(vector_update).reshape(-1, 1)
    assert np.linalg.norm(np.imag(v_)) <= 1e-16
    v = pinv_A @ v_
    beta = 1.0 + float((v_.T @ v)[0, 0])
    w = proj_A @ v_
    norm_w = np.linalg.norm(w)
    if norm_w > 1e-10:
        vw = v @ w.T
        G = (-1.0 / norm_w ** 2) * (vw + vw.T) + (beta / norm_w ** 4) * (w @ w.T)
        rank_increased = True
    elif beta > 1e-10:
        G = (-beta / abs(beta) ** 2) * (v @ v.T)
        rank_increased = False
    else:
        gamma = pinv_A @ v
        norm_v = np.linalg.norm(v)
        gv = gamma @ v.T
        G = (-1.0 / norm_v ** 2) * (gv + gv.T) \
            + (float(np.sum(v * gamma)) / norm_v ** 4) * (v @ v.conj().T)
        rank_increased = False
    return pinv_A + G, rank_increased


def _penalty_terms(l1_penalty, op_penalty, gate_penalty, germ_lengths, num_germs, germ_list):
    n = num_germs if num_germs is not None else \
        (len(germ_lengths) if germ_lengths is not None else 0)
    score = l1_penalty * n
    if op_penalty != 0.0:
        if germ_lengths is None:
            raise ValueError("Must provide germ_lengths when op_penalty != 0.0!")
        score += op_penalty * float(np.sum(germ_lengths))
    if gate_penalty is not None:
        assert germ_list is not None, "Must specify germ_list when using gate_penalty."
        for gate, penalty in gate_penalty.items():
            for circ in germ_list:
                count = sum(1 for layer in circ.layertup
                            for lbl in (layer.components
                                        if hasattr(layer, 'components') and not layer.is_simple
                                        else (layer,))
                            if getattr(lbl, 'name', str(lbl)) == gate)
                score += penalty * count
    return score


def _remove_spam_vectors(model):
    """A copy of `model` without preps and POVMs: germ selection scores only
    gate parameters (reference: germselection._remove_spam_vectors:1077)."""
    reduced = model.copy()
    for lbl in list(reduced.preps.keys()):
        del reduced.preps[lbl]
    for lbl in list(reduced.povms.keys()):
        del reduced.povms[lbl]
    reduced._mark_for_rebuild()
    return reduced


def _resolve_nongauge(num_nongauge_params, model, device="cuda"):
    if num_nongauge_params is not None:
        return num_nongauge_params
    if model is None:
        raise ValueError("Must provide either num_nongauge_params or model!")
    reduced = _remove_spam_vectors(model)
    return int(round(np.trace(_nongauge_projector(reduced, device=device))))


def compute_composite_germ_set_score_compactevd(
        current_update_cache, germ_update, score_fn="all", threshold_ac=1e6,
        init_n=1, model=None, partial_germs_list=None, eps=None,
        num_germs=None, op_penalty=0.0, l1_penalty=0.0,
        num_nongauge_params=None, num_params=None,
        force_rank_increase=False, germ_lengths=None, gate_penalty=None,
        germ_list=None, device="cuda"):
    """CompositeScore of a candidate germ set via the low-rank SPECTRUM
    update (reference: germselection.compute_composite_germ_set_score_compactevd:4305)."""
    from pygsti_tpu_torch.algorithms.scoring import CompositeScore, list_score
    fn = (lambda ev: list_score(ev, score_fn)) if isinstance(score_fn, str) else score_fn
    num_nongauge_params = _resolve_nongauge(num_nongauge_params, model, device)
    penalties = _penalty_terms(l1_penalty, op_penalty, gate_penalty, germ_lengths,
                               num_germs, germ_list)
    new_evals, rank_increased = symmetric_low_rank_spectrum_update(
        germ_update, current_update_cache[0], current_update_cache[1],
        current_update_cache[2], force_rank_increase)
    if not rank_increased:
        return CompositeScore(np.inf, -np.inf, -np.inf)
    padded = np.pad(new_evals, (num_params - len(new_evals), 0))
    observable = padded[-num_nongauge_params:]
    N_AC, AC_score = 0, np.inf
    for N in range(init_n, len(observable) + 1):
        cand = fn(observable[-N:])
        if cand > threshold_ac:
            break
        AC_score, N_AC = cand, N
    return CompositeScore(-N_AC + penalties, AC_score, N_AC)


def compute_composite_germ_set_score_low_rank_trace(
        current_update_cache, germ_update, threshold_ac=1e6, model=None,
        partial_germs_list=None, eps=None, num_germs=None, op_penalty=0.0,
        l1_penalty=0.0, num_nongauge_params=None, force_rank_increase=False,
        germ_lengths=None, gate_penalty=None, germ_list=None, device="cuda"):
    """CompositeScore via the low-rank pseudoinverse-TRACE update (reference:
    germselection.compute_composite_germ_set_score_low_rank_trace:4466)."""
    from pygsti_tpu_torch.algorithms.scoring import CompositeScore
    num_nongauge_params = _resolve_nongauge(num_nongauge_params, model, device)
    penalties = _penalty_terms(l1_penalty, op_penalty, gate_penalty, germ_lengths,
                               num_germs, germ_list)
    inverse_trace, updated_rank, rank_increased = minamide_style_inverse_trace(
        germ_update, current_update_cache[0], current_update_cache[1],
        current_update_cache[2], force_rank_increase)
    if not rank_increased:
        N_AC, AC_score = -np.inf, -np.inf
    else:
        N_AC, AC_score = updated_rank, inverse_trace
    return CompositeScore(-N_AC + penalties, AC_score, N_AC)


def compute_composite_vector_set_score(current_update_cache, vector_update, model=None,
                                       num_nongauge_params=None, force_rank_increase=False,
                                       printer=None, device="cuda"):
    """CompositeScore of adding one amplified-direction vector (reference:
    germselection.compute_composite_vector_set_score:4941)."""
    from pygsti_tpu_torch.algorithms.scoring import CompositeScore
    num_nongauge_params = _resolve_nongauge(num_nongauge_params, model, device)
    inverse_trace, rank_increased = rank_one_inverse_trace_update(
        vector_update, current_update_cache[0], current_update_cache[1],
        current_update_cache[2], force_rank_increase)
    if not rank_increased and force_rank_increase:
        return CompositeScore(np.inf, -np.inf, -np.inf)
    N_AC = current_update_cache[3] + (1 if rank_increased else 0)
    return CompositeScore(-N_AC, inverse_trace, N_AC)


def _bulk_twirled_ddd_compact(model, germ_list, tol, evd_tol=1e-10, device="cuda"):
    """Per-germ compact halves A_g (A_g A_g^T = Re(T_g^H T_g)) and their
    eigenvalue lists (reference: germselection._compute_bulk_twirled_ddd_compact:3106);
    the Grams batched on the device."""
    P = model.num_params
    Tri = _projected_twirls(model, list(germ_list), np.eye(P), tol, device)
    ddds = (Tri.transpose(1, 2) @ Tri).cpu().numpy()
    halves, eig_lists = [], []
    for DDD in ddds:
        e, U = compact_EVD(DDD, evd_tol, assume_hermitian=True)
        halves.append(U * np.sqrt(np.abs(e))[None, :])
        eig_lists.append(e)
    return halves, eig_lists


def germ_set_spanning_vectors(target_model, germ_list, float_type=None,
                              num_nongauge_params=None, tol=1e-6,
                              pretest=False, evd_tol=1e-10, verbosity=1,
                              threshold=1e6, mode='greedy',
                              update_cache_low_rank=False, final_test=True,
                              comm=None, device="cuda"):
    """Select a minimal set of amplified directions spanning the non-gauge
    parameter space across an (assumed complete) germ set, for globally
    aware fiducial pair reduction (reference:
    germselection.germ_set_spanning_vectors:4647).  Returns
    (germ_vec_dict, currentDDD)."""
    from pygsti_tpu_torch.algorithms.scoring import CompositeScore
    printer = VerbosityPrinter.create_printer(verbosity)
    num_nongauge = _resolve_nongauge(num_nongauge_params, target_model, device)
    printer.log('Number of non-gauge parameters: %d' % num_nongauge, 1)

    halves, eig_lists = _bulk_twirled_ddd_compact(target_model, germ_list, tol, evd_tol,
                                                  device)
    composite = np.concatenate(halves, axis=1)
    composite_eigs = np.concatenate(eig_lists, axis=None)
    idx_to_germ = [(germ, j) for gi, germ in enumerate(germ_list)
                   for j in range(len(eig_lists[gi]))]
    germ_vec_dict = {germ: [] for germ in germ_list}

    if mode == 'greedy':
        n_cand = composite.shape[1]
        weights = np.zeros(n_cand, np.int64)
        best0 = int(np.argmax(composite_eigs))
        weights[best0] = 1
        germ_vec_dict[idx_to_germ[best0][0]].append(
            composite[:, [best0]] / np.sqrt(composite_eigs[best0]))
        currentDDD = composite[:, [best0]] @ composite[:, [best0]].conj().T
        initN = 1
        best_score = CompositeScore(1.0e100, 0, None)
        while np.any(weights == 0) and initN < num_nongauge:
            cache = construct_update_cache_rank_one(currentDDD, evd_tol=evd_tol)
            best_score = CompositeScore(1.0e100, 0, None)
            best_idx = None
            for idx in np.where(weights == 0)[0]:
                score = compute_composite_vector_set_score(
                    cache, composite[:, [idx]], num_nongauge_params=num_nongauge)
                if score < best_score:
                    best_score, best_idx = score, int(idx)
            weights[best_idx] = 1
            initN = best_score.N
            printer.log('Best score this iteration: %s' % best_score, 2)
            sel = np.where(weights == 1)[0]
            currentDDD = composite[:, sel] @ composite[:, sel].conj().T
            germ_vec_dict[idx_to_germ[best_idx][0]].append(
                composite[:, [best_idx]] / np.sqrt(composite_eigs[best_idx]))
        if final_test and best_score.N is not None:
            evals = np.flip(np.linalg.eigvalsh(currentDDD))
            restricted = evals[:num_nongauge]
            test_rank = int(np.count_nonzero(restricted > 1e-7))
            test_trace = float(np.sum(1.0 / restricted[restricted > 1e-7]))
            if abs(test_trace - best_score.minor) > 1 or test_rank != best_score.N:
                raise ValueError('Final test failed: trace %g vs %g, rank %d vs %d'
                                 % (test_trace, best_score.minor, test_rank, best_score.N))
    elif mode == 'RRQR':
        import scipy.linalg as _sla
        _, _, Vh = np.linalg.svd(composite, full_matrices=False)
        _, Pp = _sla.qr(Vh[:num_nongauge, :], mode='r', pivoting=True)
        sel = Pp[:num_nongauge]
        for vec_idx in sel:
            germ_vec_dict[idx_to_germ[vec_idx][0]].append(
                composite[:, [vec_idx]] / np.sqrt(composite_eigs[vec_idx]))
        currentDDD = composite[:, sel] @ composite[:, sel].conj().T
    else:
        raise NotImplementedError("mode must be 'greedy' or 'RRQR'")
    return germ_vec_dict, currentDDD
