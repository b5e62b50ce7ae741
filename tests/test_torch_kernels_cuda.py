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
    elif kind == 'out_of_range':
        even = (np.arange(B) % 2 == 0)[:, None]   # odd rows keep their B_final
        cols[even & (rng.rand(B, D) < 0.1)] = -1
        cols[even & (rng.rand(B, D) < 0.1)] = K1
    G = rng.randn(K1, d, d) / 4
    if kind == 'orthogonal':
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
                 (24, 12, 12, 64, 8, 'random'), (40, 20, 128, 16, 4, 'random')):
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


@pytest.mark.cuda
def test_cuda_kernel_refuses_op_stack_beyond_shared_memory(card):
    """Buffers for one layer at d 128 and 64 outcomes (64 KB of stash per
    chain warp in float64) exceed one block's shared memory even with the
    op stack in global memory: the wrapper raises, naming the bytes it
    needs and the limit, and counts no launch."""
    dev = torch.device('cuda')
    cols = torch.zeros((2, 2), dtype=torch.int32, device=dev)
    G, E, F = (torch.zeros(s, dtype=torch.float64, device=dev)
               for s in ((2, 128, 128), (2, 64, 128), (2, 2, 128)))
    before = bwd_jacobian_accumulate.launches
    with pytest.raises(ValueError, match='bytes of shared memory.*PerBlockOptin'):
        bwd_jacobian_accumulate(cols, G, E, F)
    assert bwd_jacobian_accumulate.launches == before
