"""Taylor-term forward simulator: circuit outcome probabilities as
polynomials in the model's error-generator rates (counterpart of
pygsti_tpu/forwardsims/termforwardsim.py).

A circuit's layers decompose into static factors and exponentiated error
generators exp(sum_j theta_j L_j) whose generators are linear in their
parameters ('H', 'H+s', 'elements'-mode blocks; SPAM may be Composed with
such error maps).  Expanded around theta = 0,

    prob(theta) = c0 + sum_p c1[p] theta_p + sum_{p<=q} c2[p, q] theta_p theta_q + ...

where c1 inserts one generator into the noise-free circuit and c2 two (in
one error map: half of L_j L_k; in two: the product across the static
layers between them).  The coefficients do not depend on theta: they are
built once and evaluated at every new parameter vector.

Up to order 2 the coefficients of a list of circuits are built in torch on
`device` (default "cuda"), batched over circuits with the same number of
error maps (``bulk_coefficients``): forward states and backward effects of
the noise-free circuit, then one pass over the error maps that keeps, per
model member, the sum of the earlier insertions carried to the current
layer, so each layer contracts with K members rather than with every
earlier layer.  A ``TermCoefficients`` holds c0 [N, nE], c1 [N, nE, P] and
the upper triangle c2 [N, nE, P(P+1)/2], and evaluates probabilities and
their derivatives on the device.  ``prob_polynomials`` gives one circuit's
coefficients as host ``Polynomial``s with the JAX package's monomial keys;
orders above 2 and the 'pruned' mode expand paths on the host (numpy), as
the JAX package does, and evaluate through baseobjs/opcalc.py on `device`.

The simulator needs float64: linearity is checked at 1e-9 and the order-2
terms of probability conservation cancel to about 1e-16 of their size.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pygsti_tpu_torch.baseobjs.label import Label
from pygsti_tpu_torch.baseobjs.outcomelabeldict import OutcomeLabelDict
from pygsti_tpu_torch.baseobjs.polynomial import Polynomial, compact_polynomial_list
from pygsti_tpu_torch.baseobjs import opcalc as _opcalc

#: the largest error of a linear reconstruction of an error generator at a
#: test point before the generator counts as not linear in its parameters
LINEARITY_TOL = 1e-9
#: bytes of one chunk's order-2 work tensors in bulk_coefficients
CHUNK_BYTES = 2 << 30


class _SubLayer(object):
    """A static factor (``base``, no generators) or an error map (identity
    base, ``gens`` [nj, d, d] for the model parameters ``pidx``)."""

    __slots__ = ('base', 'pidx', 'gens')

    def __init__(self, base, pidx, gens):
        self.base = base
        self.pidx = list(pidx)
        self.gens = gens


def _linear_generators(errorgen):
    """[n, d, d] generators L_j with errorgen(theta) = sum_j theta_j L_j,
    read off the member at unit vectors and checked at a random point."""
    n = errorgen.num_params
    z = torch.zeros(n, dtype=torch.float64)
    if errorgen.to_dense(z).abs().max() > 1e-12:
        raise ValueError("Term simulator requires errorgen(0) == 0")
    eye = torch.eye(n, dtype=torch.float64)
    gens = torch.stack([errorgen.to_dense(eye[j]) for j in range(n)])
    tt = torch.as_tensor(np.random.RandomState(0).randn(n) * 0.01)
    if (errorgen.to_dense(tt) - torch.tensordot(tt, gens, dims=1)).abs().max() > LINEARITY_TOL:
        raise ValueError(
            "Term simulator requires a param-linear error generator "
            "(e.g. 'H', 'H+s', or elements-mode blocks); got a nonlinear "
            "parameterization -- use a dense simulator instead.")
    return gens.numpy()


def _decompose_errormap(op, gp_offset):
    """The ordered sub-layers of an operation (first applied first):
    static factors keep their dense matrix; each exponentiated error
    generator becomes an identity-base sub-layer with its generators.
    gp_offset: the model parameter index of the op's first parameter."""
    from pygsti_tpu_torch.modelmembers import operations as _op
    if op.num_params == 0:
        return [_SubLayer(np.asarray(op.dense()), [], np.zeros((0, op.dim, op.dim)))]
    if isinstance(op, _op.ComposedOp):
        out, off = [], gp_offset
        for f in op.factors:
            out.extend(_decompose_errormap(f, off))
            off += f.num_params
        return out
    if isinstance(op, _op.ExpErrorgenOp):
        gens = _linear_generators(op.errorgen)
        return [_SubLayer(None, range(gp_offset, gp_offset + len(gens)), gens)]
    raise ValueError("Term simulator cannot decompose operation of type %s"
                     % type(op).__name__)


class TermCoefficients(object):
    """Order-<=2 coefficients of N circuits on one device: ``c0`` [N, nE],
    ``c1`` [N, nE, P] (None at order 0), ``c2`` [N, nE, P(P+1)/2] over the
    upper triangle (row-major, ``torch.triu_indices``; None below order 2).
    ``outcomes`` are the POVM's outcome labels, one per column nE."""

    def __init__(self, circuits, outcomes, c0, c1, c2, num_params):
        self.circuits = list(circuits)
        self.outcomes = list(outcomes)
        self.c0, self.c1, self.c2 = c0, c1, c2
        self.num_params = num_params
        P = num_params
        self._iu = torch.triu_indices(P, P, device=c0.device) if c2 is not None else None

    def _v(self, v):
        return torch.as_tensor(v, dtype=self.c0.dtype, device=self.c0.device)

    def probs(self, v):
        """Probabilities [N, nE] at parameter vector `v`."""
        v = self._v(v)
        p = self.c0.clone()
        if self.c1 is not None:
            p += self.c1 @ v
        if self.c2 is not None:
            p += self.c2 @ (v[self._iu[0]] * v[self._iu[1]])
        return p

    def dprobs(self, v, chunk=256):
        """Derivatives [N, nE, P] at `v`: c1 plus the symmetric order-2
        matrix times v, unpacked `chunk` circuits at a time."""
        v = self._v(v)
        N, nE = self.c0.shape
        P = self.num_params
        if self.c1 is None:
            return torch.zeros((N, nE, P), dtype=self.c0.dtype, device=self.c0.device)
        out = self.c1.clone()
        if self.c2 is None:
            return out
        for a in range(0, N, chunk):
            c2 = self.c2[a:a + chunk]
            S = torch.zeros(c2.shape[:2] + (P, P), dtype=c2.dtype, device=c2.device)
            S[..., self._iu[0], self._iu[1]] = c2
            out[a:a + chunk] += (S + S.transpose(-1, -2)) @ v
        return out


class TermForwardSimulator(object):
    """Polynomial-probability simulator: Taylor path expansion to any
    ``max_order``, with a 'pruned' mode that keeps only paths above a
    magnitude threshold and lowers the threshold until the relative gap
    between achieved and maximum sum of path magnitudes (SOPM) is at most
    ``allowed_perr``.

    Modes:
      'taylor-order' -- exact expansion to max_order (all paths kept)
      'pruned'       -- paths with magnitude below ``min_term_mag`` dropped,
                        the threshold lowered 10x per stage (up to
                        ``max_term_stages``) until the SOPM gap criterion holds
      'direct'       -- the same polynomials as 'taylor-order'
    """

    def __init__(self, model=None, max_order=2, mode='taylor-order',
                 min_term_mag=1e-10, allowed_perr=1e-4, max_paths_per_outcome=None,
                 perr_heuristic='none', max_term_stages=5, device="cuda", dtype=torch.float64):
        assert mode in ('taylor-order', 'direct', 'pruned'), \
            "mode must be 'taylor-order', 'direct' or 'pruned'"
        if dtype != torch.float64:
            raise ValueError(
                "The Taylor-term simulator needs float64, not %s: error generators are "
                "checked for linearity at %g and the order-2 coefficients cancel to about "
                "1e-16 of their size, beyond float32's 6e-8" % (dtype, LINEARITY_TOL))
        self.model = model
        self.max_order = max_order
        self.mode = mode
        self.min_term_mag = min_term_mag
        self.allowed_perr = allowed_perr
        self.max_paths_per_outcome = max_paths_per_outcome
        self.perr_heuristic = perr_heuristic
        self.max_term_stages = max_term_stages
        self.device = torch.device(device)
        self.dtype = dtype
        self._poly_cache = {}
        self._member_sublayers = {}

    # -- model decomposition -------------------------------------------------

    def _sublayers_of(self, member, error_map=None):
        """The sub-layers of an operation, or of a composed state's or POVM's
        `error_map`, decomposed once per member at its parameter offset."""
        key = id(member)
        hit = self._member_sublayers.get(key)
        if hit is None or hit[0] is not member:
            gp = member.gpindices
            off = 0 if gp is None else (gp.start or 0) if isinstance(gp, slice) else int(gp[0])
            hit = (member, _decompose_errormap(member if error_map is None else error_map, off))
            self._member_sublayers[key] = hit
        return hit[1]

    def _layer_terms(self, lbl):
        """Ordered sub-layer list for one circuit layer."""
        ops = getattr(self.model, 'operations', None)
        if ops is None:
            raise ValueError("Term simulator needs an explicit model (operations, preps, povms)")
        if lbl in ops:
            return self._sublayers_of(ops[lbl])
        if not lbl.is_simple:
            return [s for comp in lbl.components for s in self._sublayers_of(ops[comp])]
        raise KeyError("No operation for layer %s" % str(lbl))

    def _spam_terms(self):
        from pygsti_tpu_torch.modelmembers.states import ComposedState
        from pygsti_tpu_torch.modelmembers.povms import ComposedPOVM
        model = self.model
        prep = model.preps[model._default_prep_label()]
        povm = model.povms[model._default_povm_label()]
        if isinstance(prep, ComposedState):
            prep_layers = self._sublayers_of(prep, prep.error_map)
            rho = np.asarray(prep.state_vec.dense())
        else:
            prep_layers, rho = [], np.asarray(prep.dense())
        if isinstance(povm, ComposedPOVM):
            povm_layers = self._sublayers_of(povm, povm.error_map)
            E = np.asarray(povm.base_povm.dense())
            outcomes = povm.base_povm.outcome_labels
        else:
            povm_layers, E, outcomes = [], np.asarray(povm.dense()), povm.outcome_labels
        return rho, prep_layers, E, outcomes, povm_layers

    def _build_layers(self, circuit):
        """(rho, E, outcomes, ordered sub-layer list) for a circuit."""
        self.model.to_vector()                  # places every member's gpindices
        rho, prep_layers, E, outcomes, povm_layers = self._spam_terms()
        layers = list(prep_layers)
        for lbl in circuit.layertup:
            layers.extend(self._layer_terms(Label(lbl)))
        layers.extend(povm_layers)
        return rho, E, outcomes, layers

    # -- order <= 2 on the device --------------------------------------------

    def bulk_coefficients(self, circuits, max_order=None, stats=None):
        """TermCoefficients of `circuits` to order min(max_order, 2) on
        `device`, batched over circuits with the same number of error maps.
        `stats` (a dict), if given, gets 'buckets', 'chunks', 'seconds_host'
        (the circuits' programs) and 'seconds' (the whole call)."""
        t0 = time.perf_counter()
        order = self.max_order if max_order is None else max_order
        if order > 2:
            raise ValueError("bulk_coefficients builds orders 0-2; use prob_polynomials above")
        P = self.model.num_params
        rho, E, outcomes, statics, members, progs = self._programs(circuits)
        t_host = time.perf_counter() - t0
        dev, dt = self.device, self.dtype
        nE, d = E.shape
        K = len(members)
        nj = max((len(m.pidx) for m in members), default=0)
        gens = np.zeros((K, nj, d, d))
        pidx = np.full((K, nj), P, np.int64)
        for k, m in enumerate(members):
            gens[k, :len(m.pidx)] = m.gens
            pidx[k, :len(m.pidx)] = m.pidx
        T = dict(Ms=torch.as_tensor(np.stack(statics), dtype=dt, device=dev),
                 gens=torch.as_tensor(gens, dtype=dt, device=dev),
                 pidx=torch.as_tensor(pidx.reshape(-1), device=dev),
                 rho=torch.as_tensor(rho, dtype=dt, device=dev),
                 E=torch.as_tensor(E, dtype=dt, device=dev))
        N = len(progs)
        c0 = torch.zeros((N, nE), dtype=dt, device=dev)
        c1 = torch.zeros((N, nE, P), dtype=dt, device=dev) if order >= 1 else None
        c2 = torch.zeros((N, nE, P * (P + 1) // 2), dtype=dt, device=dev) if order >= 2 else None
        iu = torch.triu_indices(P, P, device=dev)
        per_circuit = 8 * (K * K * nE * nj * nj + 3 * nE * (P + 1) ** 2 + K * nj * d)
        chunk = max(1, CHUNK_BYTES // per_circuit) if order >= 2 else 4096
        by_g = {}
        for i, (midx, kidx, fidx) in enumerate(progs):
            by_g.setdefault(len(kidx), []).append(i)
        n_chunks = 0
        for G, rows in sorted(by_g.items()):
            for a in range(0, len(rows), chunk):
                sel = rows[a:a + chunk]
                midx = torch.as_tensor([progs[i][0] for i in sel], device=dev).view(len(sel), G)
                kidx = torch.as_tensor([progs[i][1] for i in sel], device=dev).view(len(sel), G)
                fidx = torch.as_tensor([progs[i][2] for i in sel], device=dev)
                at = torch.as_tensor(sel, device=dev)
                b0, b1, b2 = self._bucket(T, midx, kidx, fidx, order, P, iu)
                c0[at] = b0
                if b1 is not None:
                    c1[at] = b1
                if b2 is not None:
                    c2[at] = b2
                n_chunks += 1
        if stats is not None:
            if dev.type == 'cuda':
                torch.cuda.synchronize(dev)
            stats.update(buckets=len(by_g), chunks=n_chunks, seconds_host=t_host,
                         seconds=time.perf_counter() - t0)
        return TermCoefficients(circuits, outcomes, c0, c1, c2, P)

    def _programs(self, circuits):
        """Each circuit as (static index before each error map, member index
        of each error map, static index after the last), with the static
        products (index 0 the identity) and the error-map members."""
        static_index, statics = {(): 0}, None
        member_index, members = {}, []
        progs, rho, E, outcomes = [], None, None, None
        products = {}
        for c in circuits:
            rho, E, outcomes, layers = self._build_layers(c)
            if statics is None:
                statics = [np.eye(len(rho))]
            midx, kidx, run = [], [], ()
            for sl in layers:
                if sl.base is not None:
                    run = run + (id(sl),)
                    products.setdefault(id(sl), sl.base)
                    continue
                midx.append(self._static(run, static_index, statics, products))
                kidx.append(member_index.setdefault(id(sl), len(members)))
                if kidx[-1] == len(members):
                    members.append(sl)
                run = ()
            if not kidx:
                raise ValueError("Term simulator needs at least one error map per circuit")
            progs.append((midx, kidx, self._static(run, static_index, statics, products)))
        return rho, E, outcomes, statics, members, progs

    @staticmethod
    def _static(run, static_index, statics, products):
        """Index of the product of the static factors `run` (ids, first
        applied first), computing it once."""
        if run not in static_index:
            mx = np.eye(len(statics[0]))
            for i in run:
                mx = products[i] @ mx
            static_index[run] = len(statics)
            statics.append(mx)
        return static_index[run]

    @staticmethod
    def _bucket(T, midx, kidx, fidx, order, P, iu):
        """c0, c1, c2 of B circuits with G error maps each."""
        Ms, gens, E = T['Ms'], T['gens'], T['E']
        B, G = kidx.shape
        K, nj, d = gens.shape[0], gens.shape[1], gens.shape[2]
        nE = E.shape[0]
        # forward states s[g] (entering error map g) and backward effects
        # b[g] (the measurement seen from just after error map g)
        s = [Ms[midx[:, 0]] @ T['rho']]
        for g in range(1, G):
            s.append((Ms[midx[:, g]] @ s[-1][..., None])[..., 0])
        b = [None] * G
        b[G - 1] = E @ Ms[fidx]
        for g in range(G - 2, -1, -1):
            b[g] = b[g + 1] @ Ms[midx[:, g + 1]]
        c0 = (b[0] * s[0][:, None, :]).sum(-1)
        if order == 0:
            return c0, None, None
        ar = torch.arange(B, device=kidx.device)
        c1m = torch.zeros((B, K, nE, nj), dtype=c0.dtype, device=c0.device)
        if order >= 2:
            # A[b, k_col, k_row, e, j_row, j_col]: coefficient of
            # theta[row] theta[col]; R[b, k, j]: the insertions L_kj of every
            # earlier error map of member k, carried to the current layer
            A = torch.zeros((B, K, K, nE, nj, nj), dtype=c0.dtype, device=c0.device)
            R = torch.zeros((B, K, nj, d), dtype=c0.dtype, device=c0.device)
        for h in range(G):
            kh = kidx[:, h]
            Lh = gens[kh]                                          # [B, nj, d, d]
            W = torch.einsum('bed,bjdc->bejc', b[h], Lh)           # b_h L_j
            c1m[ar, kh] += torch.einsum('bejc,bc->bej', W, s[h])
            if order < 2:
                continue
            if h > 0:
                R = torch.einsum('bcd,bkjd->bkjc', Ms[midx[:, h]], R)
            U = torch.einsum('bjcd,bd->bjc', Lh, s[h])             # L_j s_h
            A[ar, kh] += torch.einsum('bajc,bekc->baejk', R, W)
            A[ar, kh, kh] += 0.5 * torch.einsum('bejc,bkc->bejk', W, U)
            R[ar, kh] += U
        pidx = T['pidx']
        c1 = torch.zeros((B, nE, P + 1), dtype=c0.dtype, device=c0.device).index_add_(
            2, pidx, c1m.permute(0, 2, 1, 3).reshape(B, nE, K * nj))[..., :P]
        if order < 2:
            return c0, c1, None
        A = A.permute(0, 3, 2, 4, 1, 5).reshape(B, nE, K * nj, K * nj)
        full = torch.zeros((B, nE, P + 1, K * nj), dtype=c0.dtype, device=c0.device)
        full.index_add_(2, pidx, A)
        S = torch.zeros((B, nE, P + 1, P + 1), dtype=c0.dtype, device=c0.device)
        S.index_add_(3, pidx, full)
        S = S[..., :P, :P]
        # theta_p theta_q and theta_q theta_p are one monomial: fold the lower
        # triangle onto the upper one
        upper = S + S.transpose(-1, -2) - torch.diag_embed(torch.diagonal(S, dim1=-2, dim2=-1))
        return c0, c1, upper[..., iu[0], iu[1]]

    # -- polynomials -----------------------------------------------------------

    def prob_polynomials_general(self, circuit, max_order=None, min_term_mag=0.0):
        """Arbitrary-order Taylor expansion with optional path pruning, on the
        host.  Returns (polys, outcomes, achieved_sopm, max_sopm).  Paths are
        accumulated layer by layer as {monomial key: (state, magnitude)}
        with the within-layer recursion A_m = (1/m) sum_j theta_j L_j A_{m-1}.
        Path magnitude = prod |theta_j| ||L_j||_2 / (multiplicity factors);
        max_sopm = prod_l exp(sum_j |theta_j| ||L_j||_2) (base channels
        assumed of norm <= 1)."""
        max_order = max_order if max_order is not None else self.max_order
        rho, E, outcomes, layers = self._build_layers(circuit)
        nE = E.shape[0]
        mags = np.abs(np.asarray(self.model.to_vector()))

        max_sopm = 1.0
        opnorms = []
        for lt in layers:
            norms = [np.linalg.norm(g, 2) for g in lt.gens]
            opnorms.append(norms)
            max_sopm *= float(np.exp(sum(mags[p] * nrm for p, nrm in zip(lt.pidx, norms))))

        def accum(dct, key, state, mag):
            if key in dct:
                s0, m0 = dct[key]
                dct[key] = (s0 + state, m0 + mag)
            else:
                dct[key] = (state, mag)

        carry = {(): (rho.astype(float), 1.0)}
        for l, lt in enumerate(layers):
            new_carry = {}
            for key, (s, mag) in carry.items():
                s0 = s if lt.base is None else lt.base @ s
                accum(new_carry, key, s0, mag)
                prev = {key: (s0, mag)}
                for m in range(1, max_order - len(key) + 1):
                    nxt = {}
                    for k2, (s2, mg2) in prev.items():
                        for j, p in enumerate(lt.pidx):
                            accum(nxt, tuple(sorted(k2 + (p,))), (lt.gens[j] @ s2) / m,
                                  mg2 * mags[p] * opnorms[l][j] / m)
                    if min_term_mag > 0:
                        nxt = {k: v for k, v in nxt.items() if v[1] >= min_term_mag}
                    for k2, (s2, mg2) in nxt.items():
                        accum(new_carry, k2, s2, mg2)
                    prev = nxt
                    if not prev:
                        break
            carry = new_carry

        achieved_sopm = float(sum(mag for _, mag in carry.values()))
        polys = [Polynomial() for _ in range(nE)]
        for key, (s, _mag) in carry.items():
            vals = E @ s
            for e in range(nE):
                polys[e][key] = polys[e].get(key, 0) + float(vals[e])
        return polys, outcomes, achieved_sopm, min(max_sopm, np.inf)

    def prob_polynomials(self, circuit):
        """(list of Polynomial, one per outcome; outcomes) for `circuit`, in
        the model's parameter variables, Taylor-expanded around zero error
        rates.  Up to order 2 the coefficients come from bulk_coefficients
        on `device`; the monomials are every key of the error maps'
        parameters up to the order, as the JAX package writes them."""
        if self.mode == 'pruned':
            return self._pruned_polynomials(circuit)
        if self.max_order > 2:
            polys, outcomes, _, _ = self.prob_polynomials_general(circuit)
            return polys, outcomes
        key = (circuit, self.max_order)
        if key in self._poly_cache:
            return self._poly_cache[key]
        coeffs = self.bulk_coefficients([circuit])
        _, _, _, layers = self._build_layers(circuit)
        params = sorted({p for sl in layers for p in sl.pidx})
        P = self.model.num_params
        c0 = coeffs.c0[0].cpu().numpy()
        c1 = coeffs.c1[0].cpu().numpy() if coeffs.c1 is not None else None
        c2 = coeffs.c2[0].cpu().numpy() if coeffs.c2 is not None else None
        row = np.concatenate([[0], np.cumsum(np.arange(P, 0, -1))])   # start of row p in c2
        polys = []
        for e in range(len(c0)):
            poly = Polynomial({(): float(c0[e])})
            if c1 is not None:
                for p in params:
                    poly[(p,)] = float(c1[e, p])
            if c2 is not None:
                for i, p in enumerate(params):
                    for q in params[i:]:
                        poly[(p, q)] = float(c2[e, row[p] + q - p])
            polys.append(poly)
        out = (polys, coeffs.outcomes)
        self._poly_cache[key] = out
        return out

    def _pruned_polynomials(self, circuit):
        """Pruned-path polynomials with SOPM gap control: lower min_term_mag
        by 10x per stage until the relative SOPM gap 1 - achieved/max is <=
        allowed_perr, up to max_term_stages refinements."""
        mags_hash = hash(np.abs(np.asarray(self.model.to_vector())).round(12).tobytes())
        key = (circuit, self.max_order, 'pruned', mags_hash)
        if key in self._poly_cache:
            return self._poly_cache[key]
        mag = self.min_term_mag
        polys = outcomes = None
        for _ in range(self.max_term_stages):
            polys, outcomes, achieved, max_sopm = \
                self.prob_polynomials_general(circuit, min_term_mag=mag)
            gap = 1.0 - achieved / max_sopm if max_sopm > 0 else 0.0
            if gap <= self.allowed_perr:
                break
            mag /= 10.0
        out = (polys, outcomes)
        self._poly_cache[key] = out
        return out

    def sopm_gap(self, circuit):
        """(achieved_sopm, max_sopm) for the current parameters -- the
        pruned-path quality diagnostic."""
        _, _, achieved, max_sopm = self.prob_polynomials_general(
            circuit, min_term_mag=self.min_term_mag if self.mode == 'pruned' else 0.0)
        return achieved, max_sopm

    # -- evaluation ----------------------------------------------------------

    @staticmethod
    def _labelled(outcomes, values):
        return OutcomeLabelDict([((o,) if not isinstance(o, tuple) else o, v)
                                 for o, v in zip(outcomes, values)])

    def probs(self, circuit, clip_to=None, time=None):
        """OutcomeLabelDict of one circuit's probabilities: its polynomials
        evaluated by opcalc on `device`."""
        if time is not None:
            raise NotImplementedError(
                "the Taylor-term simulator evaluates time-independent "
                "polynomials; time-dependent probabilities are unsupported")
        polys, outcomes = self.prob_polynomials(circuit)
        v = np.asarray(self.model.to_vector())
        vt, ct = compact_polynomial_list(polys)
        vals = np.real(_opcalc.bulk_eval_compact_polynomials_complex(
            vt, ct, v.astype(complex), (len(polys),), self.device))
        if clip_to is not None:
            vals = np.clip(vals, clip_to[0], clip_to[1])
        return self._labelled(outcomes, [float(p) for p in vals])

    def bulk_probs(self, circuits, clip_to=None):
        """{circuit: OutcomeLabelDict}; up to order 2 (not 'pruned') from one
        bulk_coefficients build evaluated on `device`."""
        circuits = list(circuits)
        if self.mode == 'pruned' or self.max_order > 2:
            return {c: self.probs(c, clip_to) for c in circuits}
        coeffs = self.bulk_coefficients(circuits)
        p = coeffs.probs(self.model.to_vector()).cpu().numpy()
        if clip_to is not None:
            p = np.clip(p, clip_to[0], clip_to[1])
        return {c: self._labelled(coeffs.outcomes, [float(x) for x in row])
                for c, row in zip(circuits, p)}

    def dprobs(self, circuit):
        """Outcome-probability derivatives of one circuit (opcalc on
        `device`): OutcomeLabelDict of arrays [P]."""
        polys, outcomes = self.prob_polynomials(circuit)
        v = np.asarray(self.model.to_vector())
        P = len(v)
        vt, ct = compact_polynomial_list(polys)
        dmat = np.real(_opcalc.bulk_eval_compact_polynomials_derivs_complex(
            vt, ct, np.arange(P), v.astype(complex), (len(polys), P), self.device))
        return self._labelled(outcomes, [dmat[i] for i in range(len(outcomes))])
