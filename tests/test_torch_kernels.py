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


@pytest.mark.parametrize("extra", [0, 5], ids=['R_exact', 'R_wider'])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_out_matches_default(shape, extra):
    """With ``out`` [B, NOUT, R], R = (K1 - 1) d^2 + extra, the op blocks
    k < K1 - 1 land in out's rows bit for bit as the default call's A; the
    identity slot and the columns past (K1 - 1) d^2 are not written."""
    cols, G, E, F = (torch.as_tensor(a) for a in _inputs(6, *shape))
    B, _, K1, d, NOUT = shape
    A, Bf = bwd_jacobian_accumulate(cols, G, E, F)
    out = torch.full((B, NOUT, (K1 - 1) * d * d + extra), 7.5, dtype=G.dtype)
    got, Bf2 = bwd_jacobian_accumulate(cols, G, E, F, out)
    assert got is out and torch.equal(Bf, Bf2)
    assert torch.equal(out[:, :, :(K1 - 1) * d * d],
                       A[:, :, :K1 - 1].reshape(B, NOUT, -1))
    assert bool((out[:, :, (K1 - 1) * d * d:] == 7.5).all())
    got, _ = bwd_jacobian_accumulate_plain(cols.long(), G, E, F, out.clone())
    assert torch.equal(got, out)


@pytest.mark.parametrize("bad", ['rows', 'outcomes', 'narrow', 'dims', 'dtype',
                                 'strided', 'device'])
def test_wrapper_rejects_bad_out(bad):
    """The wrapper refuses an ``out`` of the wrong shape, dtype, layout or
    device, before it computes anything."""
    B, D, K1, d, NOUT = 4, 3, 3, 4, 2
    cols, G, E, F = (torch.as_tensor(a) for a in _inputs(2, B, D, K1, d, NOUT))
    R = (K1 - 1) * d * d
    out = {'rows': lambda: torch.zeros((B + 1, NOUT, R), dtype=G.dtype),
           'outcomes': lambda: torch.zeros((B, NOUT - 1, R), dtype=G.dtype),
           'narrow': lambda: torch.zeros((B, NOUT, R - 1), dtype=G.dtype),
           'dims': lambda: torch.zeros((B, NOUT, K1 - 1, d * d), dtype=G.dtype),
           'dtype': lambda: torch.zeros((B, NOUT, R), dtype=torch.float32),
           'strided': lambda: torch.zeros((B, NOUT, 2 * R), dtype=G.dtype)[:, :, ::2],
           'device': lambda: torch.zeros((B, NOUT, R), dtype=G.dtype, device='meta'),
           }[bad]()
    with pytest.raises(TypeError if bad == 'dtype' else ValueError):
        bwd_jacobian_accumulate(cols, G, E, F, out)


def _block_probs_jac_by_concatenation(tf, bk, dim, n_ops, n_preps, n_eff, n_out):
    """block_probs_jac as it was before the kernel wrote into Jt: the whole
    A returned, its op blocks reshaped and concatenated with the prep and
    effect columns."""
    j_dtype = torch.float64
    o_sz, p_sz = n_ops * dim * dim, n_preps * dim
    NT = o_sz + p_sz + n_eff * dim
    ops = tf[:o_sz].reshape(n_ops, dim, dim)
    preps = tf[o_sz:o_sz + p_sz].reshape(n_preps, dim)
    effects = tf[o_sz + p_sz:].reshape(n_eff, dim)
    G = torch.cat([ops, torch.eye(dim, dtype=j_dtype)[None]], dim=0)
    cols64 = bk['cols64']
    nb, Dk = cols64.shape
    E = effects[bk['eff']]
    F = torch.empty((nb, Dk, dim), dtype=j_dtype)
    S = preps[bk['prep']]
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


# (dim, n_ops, n_preps, n_eff, n_out, nb, D): 1 qubit, and 3 qubits with a
# few op slots
BLOCKS = [(4, 3, 1, 2, 2, 64, 9), (64, 5, 1, 8, 8, 6, 7)]


@pytest.mark.parametrize("block", BLOCKS, ids=['1q', '3q'])
def test_block_probs_jac_fills_jt_as_before(block):
    """block_probs_jac, with the op blocks written straight into Jt, gives
    the probabilities and Jt of the concatenating form bit for bit (short
    circuits padded with the identity slot, as bucket_plan pads them)."""
    from pygsti_tpu_torch.objectivefns.objectivefns import block_probs_jac
    dim, n_ops, n_preps, n_eff, n_out, nb, D = block
    rng = np.random.RandomState(8)
    NT = n_ops * dim * dim + n_preps * dim + n_eff * dim
    tf = torch.as_tensor(rng.randn(NT) / np.sqrt(dim))
    cols = rng.randint(0, n_ops, (nb, D)).astype(np.int32)
    depth = rng.randint(1, D + 1, nb)
    cols[np.arange(D)[None, :] >= depth[:, None]] = n_ops      # identity padding
    bk = {'cols': torch.as_tensor(cols), 'cols64': torch.as_tensor(cols).long(),
          'prep': torch.as_tensor(rng.randint(0, n_preps, nb)),
          'eff': torch.as_tensor(rng.randint(0, n_eff, (nb, n_out)))}
    p, Jt = block_probs_jac(tf, bk, dim, n_ops, n_preps, n_eff, n_out)
    p0, Jt0 = _block_probs_jac_by_concatenation(tf, bk, dim, n_ops, n_preps, n_eff, n_out)
    assert Jt.shape == (nb * n_out, NT) and Jt.is_contiguous()
    assert torch.equal(p, p0) and torch.equal(Jt, Jt0)
    assert Jt[:, :n_ops * dim * dim].abs().max() > 0


def test_wrapper_rejects_bad_inputs():
    cols, G, E, F = (torch.as_tensor(a) for a in _inputs(2, 4, 3, 3, 4, 2))
    with pytest.raises(TypeError):
        bwd_jacobian_accumulate(cols.long(), G, E, F)
    with pytest.raises(ValueError):
        bwd_jacobian_accumulate(cols, G, E, F[:, :2])
    assert bwd_jacobian_accumulate.launches == 0   # the CPU path launches nothing
