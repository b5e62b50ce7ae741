"""The CUDA kernel of pygsti_tpu_torch against its plain version, on a card.

Imports nothing of JAX, so it also runs on a machine without JAX:
    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q
(``--noconftest`` skips tests/conftest.py, which imports JAX).  Without a
card the tests skip.
"""

import numpy as np
import pytest
import torch

from pygsti_tpu_torch.ops.bwd_jacobian import (bwd_jacobian_accumulate,
                                               bwd_jacobian_accumulate_plain)

TOLS = [(torch.float64, 1e-12), (torch.float32, 1e-5)]

# (B, D, K1, d, NOUT, cols): the 2-qubit fit's five depth buckets
# ((5248, 18), (2048, 18), (3840, 36), (2048, 67), (960, 70)) cut in B, its
# deepest bucket at a larger B, a ragged B, depth 1, a depth long enough to
# walk in chunks (orthogonal ops, so that 400 products neither vanish nor
# blow up), the 1-qubit shapes, odd d and NOUT (the run-time shape path),
# every layer on one op, op indices out of range, and the shapes of the fit
# with an instrument
CASES = [
    (164, 18, 7, 16, 4, 'random'), (64, 18, 7, 16, 4, 'random'),
    (120, 36, 7, 16, 4, 'random'), (64, 67, 7, 16, 4, 'random'),
    (30, 70, 7, 16, 4, 'random'), (300, 70, 7, 16, 4, 'random'),
    (37, 70, 7, 16, 4, 'random'),
    (50, 1, 7, 16, 4, 'random'),
    (12, 400, 7, 16, 4, 'orthogonal'),
    (37, 9, 4, 4, 2, 'random'),
    (13, 10, 3, 5, 3, 'random'),
    (6, 400, 3, 5, 3, 'orthogonal'),
    (40, 30, 7, 16, 4, 'one_op'),
    (64, 70, 7, 16, 4, 'out_of_range'),
    # the 2-qubit fit with a two-member instrument: K1 = 6 ops + 2 members +
    # identity
    (300, 70, 9, 16, 4, 'random'), (37, 18, 9, 16, 4, 'random'),
    # the qutrit fit's four depth buckets ((10752, 19), (4544, 35), (3328, 66),
    # (1472, 69); d 9, NOUT 3, K1 = 4 ops + identity) cut in B, and its
    # deepest at a ragged B
    (168, 19, 5, 9, 3, 'random'), (71, 35, 5, 9, 3, 'random'),
    (52, 66, 5, 9, 3, 'random'), (23, 69, 5, 9, 3, 'random'),
    (101, 69, 5, 9, 3, 'out_of_range'),
    # op stacks beyond a block's shared memory, read from global memory: the
    # 3-qubit cloud layout's shapes (d 64, NOUT 8, K1 12), ragged and with
    # op indices out of range; d 16 at K1 60 (global in float64, shared in
    # float32) and K1 128 (global in both); K1 2 at d 128 (256 KB)
    (24, 12, 12, 64, 8, 'random'), (37, 6, 12, 64, 8, 'random'),
    (20, 12, 12, 64, 8, 'out_of_range'),
    (40, 20, 60, 16, 4, 'random'), (40, 20, 128, 16, 4, 'random'),
    (3, 5, 2, 128, 1, 'random'),
    # the 3-qubit cloud fit's buckets at full size (B 64, depths 10, 34 and
    # 68, K1 30: 29 layers and the identity), orthogonal ops so that 68
    # products neither vanish nor overflow float32, at a ragged B with op
    # indices out of range; d 128 with 64 outcomes (outcome groups of 8 in
    # the chain; once refused for its shared memory)
    (64, 10, 30, 64, 8, 'orthogonal'), (64, 34, 30, 64, 8, 'orthogonal'),
    (64, 68, 30, 64, 8, 'orthogonal'), (37, 68, 30, 64, 8, 'orthogonal_out_of_range'),
    (2, 2, 2, 128, 64, 'random'),
]

# (K1, d, NOUT, dtype, G in shared memory) on an H100 (227 KB a block; G
# stays there up to half of it)
ROUTES = [(7, 16, 4, torch.float64, True), (11, 16, 4, torch.float64, True),
          (5, 9, 3, torch.float64, True), (12, 64, 8, torch.float64, False),
          (12, 64, 8, torch.float32, False), (60, 16, 4, torch.float64, False),
          (60, 16, 4, torch.float32, True), (128, 16, 4, torch.float32, False)]


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _inputs(B, D, K1, d, NOUT, kind, dtype, seed=3):
    rng = np.random.RandomState(seed)
    cols = rng.randint(0, K1, (B, D)).astype(np.int32)
    if kind == 'one_op':
        cols[:] = 2
    elif kind.endswith('out_of_range'):
        even = (np.arange(B) % 2 == 0)[:, None]   # odd rows keep their B_final
        cols[even & (rng.rand(B, D) < 0.1)] = -1
        cols[even & (rng.rand(B, D) < 0.1)] = K1
    G = rng.randn(K1, d, d) / 4
    if kind.startswith('orthogonal'):
        G = np.stack([np.linalg.qr(g)[0] for g in G])
    dev = torch.device('cuda')
    return (torch.as_tensor(cols, device=dev),
            *(torch.as_tensor(a, device=dev).to(dtype) for a in
              (G, rng.randn(B, NOUT, d), rng.randn(B, D, d))))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=lambda c: '%dx%d_K%d_d%d_n%d_%s' % c)
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_cuda_kernel_matches_plain(card, case, dtype, tol):
    """The CUDA kernel against the plain version on the card, in float64 on
    the same inputs: 1e-12 relative for the float64 kernel, room for sums
    taken in another order (by op, then by layer), and 1e-5 for the float32
    kernel, room for its own rounding."""
    cols, G, E, F = _inputs(*case, dtype)
    before = bwd_jacobian_accumulate.launches
    A, Bf = bwd_jacobian_accumulate(cols, G, E, F)
    torch.cuda.synchronize()
    assert bwd_jacobian_accumulate.launches == before + 1
    A2, Bf2 = bwd_jacobian_accumulate_plain(cols, *(a.double() for a in (G, E, F)))
    assert A.shape == A2.shape and Bf.shape == Bf2.shape
    assert _rel(A.double(), A2) < tol
    assert _rel(Bf.double(), Bf2) < tol
    if case[-1] == 'one_op':      # the other ops' slots stay exactly zero
        assert not A[:, :, [k for k in range(case[2]) if k != 2]].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_kernel_is_deterministic(card, dtype):
    """Two launches on the same inputs give bitwise equal outputs: the
    summation order is fixed, with no atomics."""
    for case in ((300, 70, 7, 16, 4, 'random'), (12, 400, 7, 16, 4, 'random'),
                 (24, 12, 12, 64, 8, 'random'), (40, 20, 128, 16, 4, 'random'),
                 (64, 68, 30, 64, 8, 'orthogonal')):
        cols, G, E, F = _inputs(*case, dtype, seed=7)
        A, Bf = bwd_jacobian_accumulate(cols, G, E, F)
        A2, Bf2 = bwd_jacobian_accumulate(cols, G, E, F)
        assert torch.equal(A, A2) and torch.equal(Bf, Bf2)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ROUTES, ids=lambda r: 'K%d_d%d_n%d_%s' % (
    r[0], r[1], r[2], str(r[3])[6:]))
def test_cuda_kernel_route(card, route):
    """The 2-qubit and qutrit shapes keep G in shared memory; the 3-qubit
    shapes and long d 16 stacks read it from global memory."""
    from pygsti_tpu_torch.ops.bwd_jacobian import g_in_shared_memory
    K1, d, NOUT, dtype, shared = route
    G = torch.zeros((K1, d, d), dtype=dtype, device='cuda')
    assert g_in_shared_memory(G, NOUT) is shared


# (B, D, K1, d, NOUT): the shared route's compile-time and run-time paths,
# the two-stage route at 3 qubits and at d 16 past 56 ops
OUT_SHAPES = [(300, 70, 7, 16, 4), (13, 10, 3, 5, 3), (64, 68, 30, 64, 8),
              (40, 20, 128, 16, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [0, 3], ids=['R_exact', 'R_odd'])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", OUT_SHAPES, ids=lambda c: '%dx%d_K%d_d%d_n%d' % c)
def test_cuda_kernel_out_matches_default(card, shape, dtype, extra):
    """With ``out`` [B, NOUT, R] the op blocks k < K1 - 1 are the default
    call's A bit for bit, on both routes, with R a multiple of 16 bytes and
    with R odd (scalar stores); the identity slot and the columns past
    (K1 - 1) d^2 are not written; one launch per call."""
    B, D, K1, d, NOUT = shape
    cols, G, E, F = _inputs(*shape, 'orthogonal', dtype, seed=11)
    A, Bf = bwd_jacobian_accumulate(cols, G, E, F)
    R = (K1 - 1) * d * d + extra
    out = torch.full((B, NOUT, R), 7.5, dtype=dtype, device='cuda')
    before = bwd_jacobian_accumulate.launches
    got, Bf2 = bwd_jacobian_accumulate(cols, G, E, F, out)
    torch.cuda.synchronize()
    assert bwd_jacobian_accumulate.launches == before + 1
    assert got is out and torch.equal(Bf, Bf2)
    assert torch.equal(out[:, :, :(K1 - 1) * d * d], A[:, :, :K1 - 1].reshape(B, NOUT, -1))
    assert bool((out[:, :, (K1 - 1) * d * d:] == 7.5).all())


def _jt_by_concatenation(tf, bk, dim, n_ops, n_preps, n_eff, n_out):
    """block_probs_jac's Jt as it was formed before the kernel wrote into
    it: the whole A returned, its op blocks concatenated with the prep and
    effect columns."""
    dt, dev = tf.dtype, tf.device
    o_sz, p_sz = n_ops * dim * dim, n_preps * dim
    G = torch.cat([tf[:o_sz].reshape(n_ops, dim, dim),
                   torch.eye(dim, dtype=dt, device=dev)[None]])
    preps = tf[o_sz:o_sz + p_sz].reshape(n_preps, dim)
    E = tf[o_sz + p_sz:].reshape(n_eff, dim)[bk['eff']]
    nb, Dk = bk['cols'].shape
    F = torch.empty((nb, Dk, dim), dtype=dt, device=dev)
    S = preps[bk['prep']]
    for t in range(Dk):
        F[:, t] = S
        S = torch.bmm(G[bk['cols64'][:, t]], S.unsqueeze(-1)).squeeze(-1)
    A, B_final = bwd_jacobian_accumulate(bk['cols'], G, E, F)
    prep_oh = torch.nn.functional.one_hot(bk['prep'], n_preps).to(dt)
    eff_oh = torch.nn.functional.one_hot(bk['eff'], n_eff).to(dt)
    return torch.cat([A[:, :, :n_ops].reshape(nb, n_out, o_sz),
                      torch.einsum('br,bnj->bnrj', prep_oh, B_final).reshape(nb, n_out, -1),
                      torch.einsum('bne,bj->bnej', eff_oh, S).reshape(nb, n_out, -1)],
                     dim=2).reshape(nb * n_out, -1)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [(16, 6, 1, 4, 4, 128, 18), (64, 29, 1, 8, 8, 64, 34)],
                         ids=['2q', '3q'])
def test_cuda_block_probs_jac_fills_jt_as_before(card, block):
    """block_probs_jac on the card, the kernel writing the op blocks into
    Jt, gives the Jt of the concatenating form bit for bit, on the shared
    route (2 qubits) and the two-stage route (3 qubits)."""
    from pygsti_tpu_torch.objectivefns.objectivefns import block_probs_jac
    dim, n_ops, n_preps, n_eff, n_out, nb, D = block
    rng = np.random.RandomState(8)
    NT = n_ops * dim * dim + n_preps * dim + n_eff * dim
    dev = torch.device('cuda')
    tf = torch.as_tensor(np.concatenate([
        np.stack([np.linalg.qr(rng.randn(dim, dim))[0] for _ in range(n_ops)]).ravel(),
        rng.randn(NT - n_ops * dim * dim)]), device=dev)
    cols = rng.randint(0, n_ops, (nb, D)).astype(np.int32)
    cols[np.arange(D)[None, :] >= rng.randint(1, D + 1, nb)[:, None]] = n_ops
    bk = {'cols': torch.as_tensor(cols, device=dev),
          'cols64': torch.as_tensor(cols, dtype=torch.int64, device=dev),
          'prep': torch.as_tensor(rng.randint(0, n_preps, nb), device=dev),
          'eff': torch.as_tensor(rng.randint(0, n_eff, (nb, n_out)), device=dev)}
    _, Jt = block_probs_jac(tf, bk, dim, n_ops, n_preps, n_eff, n_out)
    assert torch.equal(Jt, _jt_by_concatenation(tf, bk, dim, n_ops, n_preps, n_eff, n_out))


@pytest.mark.cuda
def test_cuda_kernel_refuses_op_stack_beyond_shared_memory(card):
    """The two-stage route's chain needs two rows of the op stack and two
    of the effects in shared memory: at d 8,192 in float64 (256 KB) that
    exceeds one block's opt-in limit, so the wrapper raises, naming the
    bytes it needs and the limit, and counts no launch.  (Every shape of
    d up to 7,264 in float64 runs.)"""
    dev = torch.device('cuda')
    d = 8192
    cols = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    G, E, F = (torch.zeros(s, dtype=torch.float64, device=dev)
               for s in ((1, d, d), (1, 1, d), (1, 1, d)))
    before = bwd_jacobian_accumulate.launches
    with pytest.raises(ValueError, match='bytes of shared memory.*PerBlockOptin'):
        bwd_jacobian_accumulate(cols, G, E, F)
    assert bwd_jacobian_accumulate.launches == before
