"""The CUDA kernel of pygsti_tpu_torch against its plain version, on a card.

Imports nothing of JAX, so it also runs on a machine without JAX:
    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q
(``--noconftest`` skips tests/conftest.py, which imports JAX).  Without a
card the test skips.
"""

import numpy as np
import pytest
import torch

from pygsti_tpu_torch.ops.bwd_jacobian import (bwd_jacobian_accumulate,
                                               bwd_jacobian_accumulate_plain)


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_cuda_kernel_matches_plain(dtype, tol):
    """The CUDA kernel against the plain version on the card, at the
    2-qubit path's K1, d, NOUT and depth: 1e-12 relative in float64 and
    1e-5 in float32, room for sums taken in another order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.RandomState(3)
    B, D, K1, d, NOUT = 300, 70, 7, 16, 4
    cols = torch.as_tensor(rng.randint(0, K1, (B, D)).astype(np.int32)).cuda()
    G, E, F = (torch.as_tensor(a).cuda() for a in
               (rng.randn(K1, d, d) / 4, rng.randn(B, NOUT, d), rng.randn(B, D, d)))
    G, E, F = (a.to(dtype) for a in (G, E, F))
    before = bwd_jacobian_accumulate.launches
    A, Bf = bwd_jacobian_accumulate(cols, G, E, F)
    torch.cuda.synchronize()
    assert bwd_jacobian_accumulate.launches == before + 1
    A2, Bf2 = bwd_jacobian_accumulate_plain(cols, G, E, F)
    assert _rel(A.cpu().numpy(), A2.cpu().numpy()) < tol
    assert _rel(Bf.cpu().numpy(), Bf2.cpu().numpy()) < tol
