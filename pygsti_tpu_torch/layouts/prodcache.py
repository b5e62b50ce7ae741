"""Germ-power product-cache factorization of circuit layouts, host numpy
(counterpart of pygsti_tpu/layouts/prodcache.py; the plans are equal array
for array).

GST circuits are prepFid * germ^k * measFid, so the bulk of every circuit's
operator product can be computed once as a shared cache of subproducts --
germ powers by repeated squaring -- and each circuit reduces to
(state after its prefix) . (cached power) . (effect through its suffix).
The cache is organized in dependency LEVELS: each level is one batched
[n, d, d] matrix product, and the number of levels grows with the log of
the longest germ power.  Each row's op-index sequence is scanned for its
longest interior repeated block by vectorized autocorrelation, so plain
circuit lists factor too; a row with no repeated block becomes its own
prefix.

The plan feeds the factorized probabilities of
``forwardsims.forwardsim.SimpleForwardSimulator(probs_kernel='fact')`` and
the 'prodjac' Jacobian of ``objectivefns.objectivefns``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class LayoutFactorization(NamedTuple):
    """Static index tensors describing the factorized evaluation plan.

    Extended-table indexing convention: indices 0..K-1 address the model's
    stacked op tensors, index K is the virtual identity, and indices K+1..
    K+n_cache address cache entries in level order.  Entry i at level L is
    ``T[left[i]] @ T[right[i]]`` where both operands live at levels < L.

    Prefixes and suffixes are cache ENTRIES too (not scans): the state
    table is ``a[(m, r)] = T[a_pfx_cache[m]] @ preps[r]`` and the effect
    table is ``e[(m, o)] = effects[o] @ T[e_sfx_cache[m]]``: dense grid
    products whose tangents stay [C, small, d, d] instead of per-step
    gathers inside a scan.
    """
    levels: tuple                 # tuple of (lefts int32[n], rights int32[n])
    n_cache: int                  # total cache entries (across levels)
    a_pfx_cache: np.ndarray       # int32 [n_pfx] ext-table index per unique prefix
    n_preps: int                  # prep rows (a-grid is [n_pfx, n_preps, d])
    e_sfx_cache: np.ndarray       # int32 [n_sfx] ext-table index per unique suffix
    n_effects: int                # effect rows (e-grid is [n_sfx, n_eff, d])
    pair_g: np.ndarray            # int32 [Q] ext-table index of power block
    pair_a: np.ndarray            # int32 [Q] flat (pfx, prep) a-grid row
    elem_pair: np.ndarray         # int32 [E]
    elem_erow: np.ndarray         # int32 [E] flat (sfx, effect) e-grid row
    flops_probs: float            # estimated flops of one probs evaluation


def _best_power_blocks(op_indices, depths, max_period=16):
    """Per-row maximal interior repeated block via vectorized autocorrelation.

    Returns int32 arrays (start, period, mult): row r factors as
    ``s[:start] + w^mult + s[start+period*mult:]`` with ``w = s[start:
    start+period]``; mult == 0 marks rows with no block (mult >= 2 required).
    """
    B, D = op_indices.shape
    best_sav = np.zeros(B, dtype=np.int64)
    best_start = np.zeros(B, dtype=np.int32)
    best_p = np.ones(B, dtype=np.int32)
    best_m = np.zeros(B, dtype=np.int32)
    if D < 2 or B == 0:
        return best_start, best_p, best_m
    pos = np.arange(D)
    for p in range(1, min(max_period, D - 1) + 1):
        # match[r, t] = s[r,t] == s[r,t+p], both within the row's depth
        valid = (pos[None, : D - p] + p) < depths[:, None]
        match = (op_indices[:, p:] == op_indices[:, :-p]) & valid
        # longest run of consecutive True per row (+ its start)
        run = np.zeros(B, dtype=np.int64)
        cur = np.zeros(B, dtype=np.int64)
        run_start = np.zeros(B, dtype=np.int64)
        cur_start = np.zeros(B, dtype=np.int64)
        for t in range(D - p):
            col = match[:, t]
            cur_start = np.where(col & (cur == 0), t, cur_start)
            cur = np.where(col, cur + 1, 0)
            upd = cur > run
            run = np.where(upd, cur, run)
            run_start = np.where(upd, cur_start, run_start)
        m = (run + p) // p             # full multiplicity of the periodic block
        sav = np.where(m >= 2, (m - 1) * p, 0)
        upd = sav > best_sav           # strict >: ties keep the smaller period
        best_sav = np.where(upd, sav, best_sav)
        best_start = np.where(upd, run_start.astype(np.int32), best_start)
        best_p = np.where(upd, np.int32(p), best_p)
        best_m = np.where(upd, m.astype(np.int32), best_m)
    best_m = np.where(best_sav > 0, best_m, 0).astype(np.int32)
    return best_start, best_p, best_m


def _find_known_word(seq, words_by_len, max_positions=4096):
    """Longest known word occurring as a substring of seq -> (start, word)
    or (None, None).  Used to route power-free rows (e.g. the L=1 GST
    circuits, prepFid*germ*measFid) through already-cached germ products.

    Cost is O(positions x word-lengths) tuple-hash probes per row;
    `max_positions` caps the probes per row so a pathological layout (very
    long power-free rows x many distinct word lengths) degrades to "no
    shared word" -- the row still evaluates correctly through its own
    prefix entry -- instead of quadratic host time."""
    n = len(seq)
    probes = 0
    for wl in sorted(words_by_len.keys(), reverse=True):
        if wl > n:
            continue
        words = words_by_len[wl]
        for start in range(n - wl + 1):
            probes += 1
            if probes > max_positions:
                return None, None
            if seq[start:start + wl] in words:
                return start, seq[start:start + wl]
    return None, None


class _CacheBuilder:
    """Hash-consed subsequence product cache with power-aware splitting."""

    def __init__(self, identity_index):
        self.identity_index = identity_index
        self.memo = {(): identity_index}
        self.entries = []   # (left_ref, right_ref); refs are ints (base ops)
        #                     or ('c', i) provisional cache markers

    def build(self, seq):
        """Provisional extended-table ref of prod(seq) = G[s_n]...G[s_1]."""
        seq = tuple(seq)
        hit = self.memo.get(seq)
        if hit is not None:
            return hit
        n = len(seq)
        if n == 1:
            self.memo[seq] = int(seq[0])
            return int(seq[0])
        # power-aware split: smallest period p with seq = w^m, m >= 2
        h = None
        for p in range(1, n // 2 + 1):
            if n % p == 0 and seq == seq[:p] * (n // p):
                h = p * ((n // p) // 2)
                break
        if h is None:
            h = n // 2
        right = self.build(seq[:h])    # earlier part (applied first)
        left = self.build(seq[h:])     # later part
        prov = ('c', len(self.entries))
        self.entries.append((left, right))
        self.memo[seq] = prov
        return prov

    def finalize(self):
        """Assign level-ordered final indices; return (levels, n_cache,
        resolve) where resolve maps provisional indices -> final int."""
        K1 = self.identity_index + 1   # base ops + identity
        depth = {}
        for i, (l, r) in enumerate(self.entries):
            dl = depth[l[1]] if isinstance(l, tuple) else 0
            dr = depth[r[1]] if isinstance(r, tuple) else 0
            depth[i] = 1 + max(dl, dr)
        order = sorted(range(len(self.entries)), key=lambda i: (depth[i], i))
        final_of = {}
        for pos, i in enumerate(order):
            final_of[i] = K1 + pos

        def resolve(ref):
            return final_of[ref[1]] if isinstance(ref, tuple) else int(ref)

        levels = []
        cur_d, lefts, rights = None, [], []
        for i in order:
            d = depth[i]
            l, r = self.entries[i]
            if d != cur_d:
                if lefts:
                    levels.append((np.asarray(lefts, np.int32),
                                   np.asarray(rights, np.int32)))
                cur_d, lefts, rights = d, [], []
            lefts.append(resolve(l))
            rights.append(resolve(r))
        if lefts:
            levels.append((np.asarray(lefts, np.int32),
                           np.asarray(rights, np.int32)))
        return tuple(levels), len(self.entries), resolve


class ElementGroupTables(NamedTuple):
    """Padded element groupings for the dproduct-cache Jacobian
    ('prodjac'; see objectivefns._prodjac_jacobian_fns).

    The Jacobian element assembly is
        Jt[c, e] = de[c, erow_e] . X[pair_e]  +  e[erow_e] . dX[c, pair_e]
    Materializing the per-element gathers of de/dX ([C, E, d]) is
    bandwidth-prohibitive, so elements are grouped by shared erow (term 1)
    and by shared pair (term 2): each group contracts ONE de/dX row against
    a padded block of partners as a batched matmul, and a flat permutation
    gathers the results back to element order.  Groups are chunked to
    `chunk` slots so a single popular row (e.g. the empty measurement
    fiducial) cannot blow up the padding.
    """
    erow_chunk_row: np.ndarray    # int32 [Gs]    e-grid row per chunk
    erow_chunk_pair: np.ndarray   # int32 [Gs, L] pair index per slot (0-pad)
    erow_perm: np.ndarray         # int32 [E]     flat (chunk, slot) per element
    pair_chunk_q: np.ndarray      # int32 [Gq]    pair index per chunk
    pair_chunk_erow: np.ndarray   # int32 [Gq, L] e-grid row per slot (0-pad)
    pair_perm: np.ndarray         # int32 [E]


def build_element_group_tables(fact, chunk=64):
    """Build :class:`ElementGroupTables` for a :class:`LayoutFactorization`."""
    def group(keys, partners):
        order = np.argsort(keys, kind='stable')
        chunks_key, chunks_partner, perm_flat = [], [], np.empty(
            len(keys), np.int64)
        i = 0
        n = len(keys)
        while i < n:
            k = keys[order[i]]
            j = i
            while j < n and keys[order[j]] == k:
                j += 1
            for s in range(i, j, chunk):
                rows = order[s:min(s + chunk, j)]
                g = len(chunks_key)
                chunks_key.append(k)
                padded = np.zeros(chunk, np.int32)
                padded[:len(rows)] = partners[rows]
                chunks_partner.append(padded)
                perm_flat[rows] = g * chunk + np.arange(len(rows))
            i = j
        return (np.asarray(chunks_key, np.int32),
                np.stack(chunks_partner) if chunks_partner
                else np.zeros((0, chunk), np.int32),
                perm_flat.astype(np.int32))

    erow = np.asarray(fact.elem_erow)
    pair = np.asarray(fact.elem_pair)
    er_row, er_pair, er_perm = group(erow, pair)
    pr_q, pr_erow, pr_perm = group(pair, erow)
    return ElementGroupTables(er_row, er_pair, er_perm,
                              pr_q, pr_erow, pr_perm)


def factorize_layout(layout, max_period=16):
    """Build a :class:`LayoutFactorization` for a compiled layout, or None
    when factorization is not applicable (no rows)."""
    op_indices = layout.op_indices
    B, D = op_indices.shape
    if B == 0:
        return None
    depths = layout.depths
    identity = layout.identity_index

    start, period, mult = _best_power_blocks(op_indices, depths, max_period)

    rows = [tuple(op_indices[r, :depths[r]].tolist()) for r in range(B)]

    # collect power words, then give power-free rows a known-word block
    words = {}
    for r in range(B):
        if mult[r] >= 2:
            words.setdefault(int(period[r]), set()).add(
                rows[r][start[r]:start[r] + period[r]])
    words_by_len = {wl: ws for wl, ws in words.items()}

    cache = _CacheBuilder(identity)
    row_prefix = [None] * B
    row_suffix = [None] * B
    row_gref = [None] * B
    for r in range(B):
        s = rows[r]
        if mult[r] >= 2:
            a, p, m = int(start[r]), int(period[r]), int(mult[r])
            w = s[a:a + p]
            row_prefix[r] = s[:a]
            row_suffix[r] = s[a + p * m:]
            row_gref[r] = cache.build(w * m)
        else:
            a, w = _find_known_word(s, words_by_len) if s else (None, None)
            if w is not None:
                row_prefix[r] = s[:a]
                row_suffix[r] = s[a + len(w):]
                row_gref[r] = cache.build(w)
            else:
                row_prefix[r] = s
                row_suffix[r] = ()
                row_gref[r] = identity

    # prefixes and suffixes become cache entries themselves (binary-split,
    # hash-consed -- shared subsequences across fiducials build once)
    pfx_index = {}        # prefix seq -> dense pfx id
    row_pfx = np.empty(B, np.int32)
    sfx_index = {}        # suffix seq -> dense sfx id
    row_sfx = np.empty(B, np.int32)
    pfx_refs, sfx_refs = [], []
    for r in range(B):
        s = row_prefix[r]
        i = pfx_index.get(s)
        if i is None:
            i = len(pfx_index)
            pfx_index[s] = i
            pfx_refs.append(cache.build(s))
        row_pfx[r] = i
        s = row_suffix[r]
        i = sfx_index.get(s)
        if i is None:
            i = len(sfx_index)
            sfx_index[s] = i
            sfx_refs.append(cache.build(s))
        row_sfx[r] = i

    levels, n_cache, resolve = cache.finalize()
    row_g = np.asarray([resolve(g) for g in row_gref], np.int32)
    a_pfx_cache = np.asarray([resolve(p) for p in pfx_refs], np.int32)
    e_sfx_cache = np.asarray([resolve(s) for s in sfx_refs], np.int32)

    n_preps = max(int(layout.prep_index.max()) + 1, 1) if B else 1
    row_a = row_pfx * n_preps + layout.prep_index.astype(np.int32)

    # -- pair table: unique (g, a-grid row) ---------------------------------
    pair_index = {}
    row_pair = np.empty(B, np.int32)
    for r in range(B):
        key = (int(row_g[r]), int(row_a[r]))
        q = pair_index.get(key)
        if q is None:
            q = len(pair_index)
            pair_index[key] = q
        row_pair[r] = q
    Q = len(pair_index)
    pair_g = np.empty(Q, np.int32)
    pair_a = np.empty(Q, np.int32)
    for (g, ia), q in pair_index.items():
        pair_g[q] = g
        pair_a[q] = ia

    # -- element maps (vectorized) -------------------------------------------
    elem_effect = layout.elem_effect
    elem_circuit = layout.elem_circuit     # holds the ROW index per element
    n_eff_tot = int(elem_effect.max()) + 1 if layout.num_elements else 1
    elem_erow = (row_sfx[elem_circuit].astype(np.int64) * n_eff_tot
                 + elem_effect.astype(np.int64)).astype(np.int32)
    elem_pair = row_pair[elem_circuit].astype(np.int32)

    d = layout.dim
    n_lvl_entries = sum(len(l) for l, _ in levels)
    flops_probs = float(
        2 * n_lvl_entries * d ** 3                        # cache levels
        + 2 * len(a_pfx_cache) * n_preps * d * d          # a grid
        + 2 * len(e_sfx_cache) * n_eff_tot * d * d        # e grid
        + 2 * Q * d * d                                   # X = C @ a
        + 2 * layout.num_elements * d)                    # element dots

    return LayoutFactorization(
        levels=levels, n_cache=n_cache,
        a_pfx_cache=a_pfx_cache, n_preps=n_preps,
        e_sfx_cache=e_sfx_cache, n_effects=n_eff_tot,
        pair_g=pair_g, pair_a=pair_a,
        elem_pair=elem_pair, elem_erow=elem_erow,
        flops_probs=flops_probs)
