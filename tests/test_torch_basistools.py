"""tools/basistools.py, tools/jamiolkowski.py and tools/lindbladtools.py of
the port against the JAX package's on the same seeded inputs, at 1 and 2
qubits.  Tolerance 1e-12 absolute: both are the same host numpy arithmetic.
"""

import numpy as np
import pytest

import pygsti_tpu.modelpacks.smq1Q_XYI as jmp1
import pygsti_tpu.modelpacks.smq2Q_XYICNOT as jmp2
from pygsti_tpu.baseobjs.basis import Basis as JBasis
from pygsti_tpu.tools import basistools as jbt
from pygsti_tpu.tools import jamiolkowski as jjam
from pygsti_tpu.tools import lindbladtools as jlt

import pygsti_tpu_torch.modelpacks.smq1Q_XYI as tmp1
import pygsti_tpu_torch.modelpacks.smq2Q_XYICNOT as tmp2
from pygsti_tpu_torch.baseobjs.basis import Basis, BuiltinBasis, DirectSumBasis
from pygsti_tpu_torch.convert import model_from_vector
from pygsti_tpu_torch.tools import basistools as tbt
from pygsti_tpu_torch.tools import jamiolkowski as tjam
from pygsti_tpu_torch.tools import lindbladtools as tlt

TOL = 1e-12
PACKS = {1: (jmp1, tmp1), 2: (jmp2, tmp2)}


def close(a, b):
    return np.asarray(a).shape == np.asarray(b).shape and \
        np.max(np.abs(np.asarray(a) - np.asarray(b)), initial=0.0) < TOL


def random_density(d, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d))
    rho = a @ a.conj().T
    return rho / np.trace(rho)


@pytest.mark.parametrize('nq', [1, 2])
def test_vector_conversions(nq):
    d = 2 ** nq
    rho = random_density(d, nq)
    for name in ('stdmx_to_ppvec', 'stdmx_to_gmvec', 'stdmx_to_stdvec'):
        assert close(getattr(tbt, name)(rho), getattr(jbt, name)(rho)), name
        v = getattr(jbt, name)(rho)
        back = name.replace('stdmx_to_', '') + '_to_stdmx'
        assert close(getattr(tbt, back)(v), getattr(jbt, back)(v)), back
        assert close(getattr(tbt, back)(v), rho), back
    psi = np.linalg.eigh(rho)[1][:, -1]
    assert close(tbt.state_to_stdmx(psi), jbt.state_to_stdmx(psi))
    assert close(tbt.state_to_pauli_density_vec(psi), jbt.state_to_pauli_density_vec(psi))


@pytest.mark.parametrize('nq', [1, 2])
def test_basis_helpers(nq):
    d2 = 4 ** nq
    mx = np.random.default_rng(nq).standard_normal((d2, d2))
    for name in ('pp', 'gm', 'std'):
        assert close(tbt.basis_matrices(name, d2), jbt.basis_matrices(name, d2))
        assert tbt.basis_longname(name) == jbt.basis_longname(name)
        assert tbt.basis_longname(Basis.cast(name, d2)) == jbt.basis_longname(
            JBasis.cast(name, d2))
        assert [str(x) for x in tbt.basis_element_labels(name, d2)] == \
            [str(x) for x in jbt.basis_element_labels(name, d2)]
        assert tbt.create_basis_for_matrix(mx, name).name == \
            jbt.create_basis_for_matrix(mx, name).name
        pair_t, pair_j = tbt.create_basis_pair(mx, name, 'pp'), jbt.create_basis_pair(mx, name,
                                                                                      'pp')
        assert [b.name for b in pair_t] == [b.name for b in pair_j]
        assert [b.dim for b in pair_t] == [b.dim for b in pair_j]
        for to in ('pp', 'gm', 'std'):
            assert close(tbt.flexible_change_basis(mx, name, to),
                         jbt.flexible_change_basis(mx, name, to)), (name, to)
    assert tbt.is_sparse_basis('pp') == jbt.is_sparse_basis('pp') is False
    assert tbt.is_cvxpy_expression(mx) == jbt.is_cvxpy_expression(mx) is False


def test_flexible_change_basis_across_a_direct_sum():
    """A qubit block plus one extra level (d 3): expanding a superoperator
    on the direct sum into 'gm' of the whole space and contracting it back
    gives it back, and the expanded map acts on the qubit block's density
    matrices as the original does.  (The JAX package pads the std matrix
    with zeros here instead, which mixes the indices of 2 x 2 and 3 x 3
    matrices: ROADMAP.md section 3.)"""
    ds = DirectSumBasis([BuiltinBasis('pp', 4), BuiltinBasis('std', 1)])
    M = np.random.default_rng(5).standard_normal((5, 5))
    whole = BuiltinBasis('gm', 9)
    big = tbt.flexible_change_basis(M, ds, whole)
    assert big.shape == (9, 9)
    assert close(tbt.flexible_change_basis(big, whole, ds), M)
    rho = np.zeros((3, 3), complex)
    rho[:2, :2] = random_density(2, 7)
    x_ds = np.linalg.lstsq(ds.to_elementstd_transform_matrix(), rho.reshape(-1), rcond=None)[0]
    out_small = (ds.to_elementstd_transform_matrix() @ (M @ x_ds)).reshape(3, 3)
    out_big = tbt.vec_to_stdmx(big @ tbt.stdmx_to_vec(rho, whole), whole)
    assert np.max(np.abs(out_big - out_small)) < 1e-12


@pytest.mark.parametrize('nq', [1, 2])
def test_negative_choi_eigenvalues(nq):
    """A model with its gates moved off the CP set (a seeded 0.02
    perturbation of the 'full' target): the per-gate sums, their total, the
    magnitudes, and one gate's sum."""
    jmp, tmp = PACKS[nq]
    jm = jmp.target_model('full')
    v = jm.to_vector()
    jm.from_vector(v + 0.02 * np.random.default_rng(nq).standard_normal(len(v)))
    tm = model_from_vector(tmp.target_model('full'), jm.to_vector())
    sums = tjam.sums_of_negative_choi_eigenvalues(tm)
    assert close(sums, jjam.sums_of_negative_choi_eigenvalues(jm)) and min(sums) > 0
    assert abs(tjam.sum_of_negative_choi_eigenvalues(tm)
               - jjam.sum_of_negative_choi_eigenvalues(jm)) < TOL
    assert close(tjam.magnitudes_of_negative_choi_eigenvalues(tm),
                 jjam.magnitudes_of_negative_choi_eigenvalues(jm))
    for lbl in jm.operations.keys():
        g = np.asarray(jm.operations[lbl].to_dense())
        assert abs(tjam.sum_of_negative_choi_eigenvalues_gate(g)
                   - jjam.sum_of_negative_choi_eigenvalues_gate(g)) < TOL
    target = tmp.target_model('full')
    assert tjam.sum_of_negative_choi_eigenvalues(target) < 1e-12


@pytest.mark.parametrize('nq', [1, 2])
@pytest.mark.parametrize('typ', ['H', 'S', 'C', 'A'])
def test_elementary_errorgens(nq, typ):
    d2 = 4 ** nq
    els = Basis.cast('pp', d2).elements
    for mx_basis in ('pp', 'std'):
        assert close(tlt.elementary_errorgens_matrix(typ, els, mx_basis),
                     jlt.elementary_errorgens_matrix(typ, els, mx_basis))
    p, q = els[1] * np.sqrt(2 ** nq), els[-1] * np.sqrt(2 ** nq)      # Pauli matrices
    args = (p,) if typ in 'HS' else (p, q)
    assert close(tlt.create_elementary_errorgen_pauli(typ, *args),
                 jlt.create_elementary_errorgen_pauli(typ, *args))
    assert close(tlt.create_elementary_errorgen_dual_pauli(typ, *args),
                 jlt.create_elementary_errorgen_dual_pauli(typ, *args))
