"""Circuit probabilities and the GST objectives, in plain PyTorch.

A design is a layer table and, per circuit, its layers as indices into the
table, padded with -1.  A circuit's probabilities are E (G_L ... G_1 rho),
the first layer applied first.  The objectives are pyGSTi's published
per-element terms of the probability p, the count c and the circuit's
total t (f = c / t):

  chi2: t (p - f)^2 / max(p, mpc)                  (mpc: min_prob_clip_for_weighting)
  logl: c log(f / p) - c + t p   for c > 0, p >= minp (Poisson picture, half of 2 Delta logL),
        its value at minp plus S (p - minp) + S2 (p - minp)^2 below minp,
            S = t - c / minp, S2 = c / (2 minp^2)
        t p  for c = 0, p >= r; t (-p^3 / (3 r^2) + p^2 / r + r / 3) below r

pyGSTi's older chi2 also clipped p at 1 - mpc from above; its current
objective, and the program under test, clip from below only, as here.
The gradient is autograd's; the Jacobian of the probabilities is forward
mode, one tangent per parameter, in chunks.
"""

from __future__ import annotations

import torch


def probabilities(ops, rho, effects, seqs):
    """[N, M] outcome probabilities.  ops [K, d, d] (the layer table's),
    rho [d], effects [M, d], seqs [N, D] int64 (-1 past a circuit's end)."""
    K, d, _ = ops.shape
    eye = torch.eye(d, dtype=ops.dtype, device=ops.device)
    stack = torch.cat([ops, eye[None]])
    idx = torch.where(seqs < 0, K, seqs)
    s = rho.expand(seqs.shape[0], d)
    for t in range(seqs.shape[1]):
        s = torch.einsum('nij,nj->ni', stack[idx[:, t]], s)
    return s @ effects.T


def terms(kind, p, c, t, regs):
    """Per-element objective terms (module note) of probabilities p, counts
    c and totals t (broadcast against p)."""
    pos_c = c > 0
    f = torch.where(pos_c, c / t, torch.ones_like(c))
    if kind == 'chi2':
        mpc = regs['min_prob_clip_for_weighting']
        return t * (p - c / t) ** 2 / torch.clamp(p, min=mpc)
    if kind != 'logl':
        raise ValueError("unknown objective %r" % kind)
    minp, r = regs['min_prob_clip'], regs['radius']
    pos = torch.clamp(p, min=minp)
    v = torch.where(pos_c, c * torch.log(f / pos), torch.zeros_like(p)) - c + t * pos
    S = t - c / minp
    S2 = c / (2 * minp ** 2)
    v = torch.where(p < minp, v + S * (p - minp) + S2 * (p - minp) ** 2, v)
    zf = t * torch.where(p >= r, p, -p ** 3 / (3 * r ** 2) + p ** 2 / r + r / 3)
    return torch.where(pos_c, v, zf)


def chi2k_factor(kind):
    """The factor from the sum of the terms to the chi2_k-distributed value
    the program reports (2 Delta logL for logl, chi2 itself)."""
    return 2.0 if kind == 'logl' else 1.0


class Problem(object):
    """One model against one dataset: the reference side of a check.

    `model` is a reference model (models.py), `layers` the design's layer
    table, `seqs` [N, D] its circuits, `counts` [N, M] and `totals` [N]
    the data, `kind`/`regs` the objective."""

    def __init__(self, model, layers, seqs, counts, totals, kind, regs, dtype, device):
        self.model = model
        self.dtype, self.device = dtype, device
        self.const = model.constants(layers, dtype, device)
        self.seqs = torch.as_tensor(seqs, device=device)
        self.counts = torch.as_tensor(counts, dtype=dtype, device=device)
        self.totals = torch.as_tensor(totals, dtype=dtype, device=device)[:, None]
        self.kind, self.regs = kind, regs

    def _theta(self, theta):
        return torch.as_tensor(theta, device=self.device).to(self.dtype)

    def probs(self, theta):
        ops, rho, effects = self.model.split(self._theta(theta), self.const)
        return probabilities(ops, rho, effects, self.seqs)

    def terms(self, theta):
        return terms(self.kind, self.probs(theta), self.counts, self.totals, self.regs)

    def value(self, theta):
        """The chi2_k-distributed objective value (chi2, or 2 Delta logL)."""
        with torch.no_grad():
            return float(self.terms(theta).sum()) * chi2k_factor(self.kind)

    def gradient(self, theta):
        """d/dtheta of the sum of the terms, by autograd."""
        x = self._theta(theta).clone().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(self.terms(x).sum(), x)
        return g.detach()

    def jacobian(self, theta, chunk=32):
        """d probabilities / d theta [N * M, P], by forward mode."""
        x = self._theta(theta)
        const = self.model.at_point(x, self.const)

        def probs(v):
            ops, rho, effects = self.model.split(v, const)
            return probabilities(ops, rho, effects, self.seqs).reshape(-1)

        P = x.shape[0]
        cols = []
        eye = torch.eye(P, dtype=x.dtype, device=x.device)
        for a in range(0, P, chunk):
            tangents = eye[a:a + chunk]
            jv = torch.func.vmap(lambda t: torch.func.jvp(probs, (x,), (t,))[1])(tangents)
            cols.append(jv.T)
        return torch.cat(cols, dim=1)

    def newton_decrement(self, theta, rcond=1e-10):
        """(decrement, J, dterms): half of g^T H^+ g with g = J^T dterms and
        the Gauss-Newton Hessian H = J^T diag(d2 terms / dp2) J of the
        probabilities (eigenvalues under rcond of the largest dropped: the
        gauge).  It is the fall of the objective's terms that one Newton step
        from theta would give: about 0 at an optimum."""
        J = self.jacobian(theta)
        p = self.probs(theta).detach().reshape(-1).clone().requires_grad_(True)
        c, t = self.counts.reshape(-1), self.totals.expand_as(self.counts).reshape(-1)
        with torch.enable_grad():
            tm = terms(self.kind, p, c, t, self.regs)
            (dt,) = torch.autograd.grad(tm.sum(), p, create_graph=True)
            (h,) = torch.autograd.grad(dt.sum(), p)
        dt = dt.detach()
        g = J.T @ dt
        H = J.T @ (h[:, None] * J)
        w, V = torch.linalg.eigh(H)
        keep = w > rcond * w.max()
        y = V[:, keep].T @ g
        dec = 0.5 * float((y * y / w[keep]).sum())
        return dec, J, dt
