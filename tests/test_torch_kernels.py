"""The port's backward-accumulation kernel module against the JAX package's.

On the CPU the port's wrapper runs ``bwd_jacobian_accumulate_plain``; the
CUDA kernel itself is checked against it in test_torch_kernels_cuda.py (on
a card) and by chip_smoke.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pygsti_tpu.ops import pallas_kernels as pk
from pygsti_tpu_torch.ops.bwd_jacobian import (bwd_jacobian_accumulate,
                                               bwd_jacobian_accumulate_plain)


def _inputs(seed, B, D, K1, d, NOUT):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, K1, (B, D)).astype(np.int32),
            rng.randn(K1, d, d) / 4, rng.randn(B, NOUT, d), rng.randn(B, D, d))


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


# (B, D, K1, d, NOUT): the 1-qubit and 2-qubit GST shapes, cut in batch/depth
SHAPES = [(16, 7, 4, 4, 2), (24, 9, 7, 16, 4)]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_reference_f64(shape):
    """Same scan in float64, summed in the same order: 1e-12 relative
    leaves room only for last-bit differences between the einsum paths."""
    cols, G, E, F = _inputs(0, *shape)
    A_j, Bf_j = pk.bwd_jacobian_accumulate_reference(
        jnp.asarray(cols), jnp.asarray(G), jnp.asarray(E), jnp.asarray(F))
    A_t, Bf_t = bwd_jacobian_accumulate(
        torch.as_tensor(cols), torch.as_tensor(G), torch.as_tensor(E),
        torch.as_tensor(F))
    assert _rel(A_t.numpy(), np.asarray(A_j)) < 1e-12
    assert _rel(Bf_t.numpy(), np.asarray(Bf_j)) < 1e-12


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_reference_out_of_range_ops(shape):
    """Op indices -1 and K1 select no op in the JAX reference (a zero
    one-hot row: nothing added to A, the effect row zeroed); the plain
    version must do the same, at the same 1e-12 relative in float64."""
    cols, G, E, F = _inputs(4, *shape)
    B, D, K1 = shape[0], shape[1], shape[2]
    rng = np.random.RandomState(5)
    # even rows only: one such layer zeroes the row's B_final for good
    even = (np.arange(B) % 2 == 0)[:, None]
    cols[even & (rng.rand(B, D) < 0.15)] = -1
    cols[even & (rng.rand(B, D) < 0.15)] = K1
    cols[0, 1], cols[2, 2] = -1, K1
    A_j, Bf_j = pk.bwd_jacobian_accumulate_reference(
        jnp.asarray(cols), jnp.asarray(G), jnp.asarray(E), jnp.asarray(F))
    A_t, Bf_t = bwd_jacobian_accumulate(
        torch.as_tensor(cols), torch.as_tensor(G), torch.as_tensor(E),
        torch.as_tensor(F))
    assert np.abs(np.asarray(A_j)).max() > 0
    assert _rel(A_t.numpy(), np.asarray(A_j)) < 1e-12
    assert _rel(Bf_t.numpy(), np.asarray(Bf_j)) < 1e-12


def test_plain_matches_pallas_kernel_f32():
    """float32 against the Pallas kernel in interpret mode (as
    tests/test_pallas_kernels.py runs it): 1e-5 relative covers float32
    sums taken in another order over depth 9."""
    from jax.experimental import pallas as pl
    B, D, K1, d, NOUT, TB = 32, 9, 7, 16, 4, 16
    cols, G, E, F = _inputs(1, B, D, K1, d, NOUT)
    G, E, F = (a.astype(np.float32) for a in (G, E, F))
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        A_j, Bf_j = pk.bwd_jacobian_accumulate(
            jnp.asarray(cols), jnp.asarray(G), jnp.asarray(E), jnp.asarray(F),
            tile=TB)
    finally:
        pl.pallas_call = orig
    A_t, Bf_t = bwd_jacobian_accumulate(
        torch.as_tensor(cols), torch.as_tensor(G), torch.as_tensor(E),
        torch.as_tensor(F))
    assert A_t.dtype == torch.float32
    assert _rel(A_t.numpy(), np.asarray(A_j)) < 1e-5
    assert _rel(Bf_t.numpy(), np.asarray(Bf_j)) < 1e-5


def test_wrapper_rejects_bad_inputs():
    cols, G, E, F = (torch.as_tensor(a) for a in _inputs(2, 4, 3, 3, 4, 2))
    with pytest.raises(TypeError):
        bwd_jacobian_accumulate(cols.long(), G, E, F)
    with pytest.raises(ValueError):
        bwd_jacobian_accumulate(cols, G, E, F[:, :2])
    assert bwd_jacobian_accumulate.launches == 0   # the CPU path launches nothing
