"""The port's basis constructors and basis classes against the JAX
package's: the builtin matrices and labels within 1e-15, the elements,
labels and transform matrices of the explicit, tensor-product, direct-sum
and lazy bases, default_basis_for_udims, and resize_mx both ways."""

import numpy as np
import pytest

import pygsti_tpu.baseobjs.basis as jb
import pygsti_tpu.baseobjs.basisconstructors as jbc
import pygsti_tpu.tools.basistools as jbt
import pygsti_tpu_torch.baseobjs.basis as tb
import pygsti_tpu_torch.baseobjs.basisconstructors as tbc
import pygsti_tpu_torch.tools.basistools as tbt

CONSTRUCTORS = [('std', 2), ('std', 3), ('pp', 2), ('pp', 4), ('pp', 8), ('gm', 2),
                ('gm', 3), ('gm', 4), ('qt', 3), ('lf', 3)]


@pytest.mark.parametrize("name,d", CONSTRUCTORS)
def test_constructors(name, d):
    """Each constructor's matrices within 1e-15 and its labels equal."""
    jm, tm = getattr(jbc, name + '_matrices')(d), getattr(tbc, name + '_matrices')(d)
    assert jm.shape == tm.shape and np.max(np.abs(jm - tm)) <= 1e-15
    assert getattr(jbc, name + '_labels')(d) == getattr(tbc, name + '_labels')(d)


@pytest.mark.parametrize("name,dim", [('std', 4), ('pp', 16), ('PP', 4), ('gm', 9),
                                      ('qt', 9), ('l2p1', 9)])
def test_builtin_basis(name, dim):
    jbb, tbb = jb.BuiltinBasis(name, dim), tb.BuiltinBasis(name, dim)
    _same_basis(jbb, tbb)
    assert tbb.implies_leakage_modeling() == jbb.implies_leakage_modeling()
    assert tbb.is_normalized() == jbb.is_normalized()
    assert tbb.first_element_is_identity == jbb.first_element_is_identity


def _same_basis(j, t):
    """Names, dims, labels, elements and the transform matrices (to the
    element-std space, and to 'std' where the dimension is a square)."""
    assert t.name == j.name and t.dim == j.dim and t.size == j.size
    assert [str(x) for x in t.labels] == [str(x) for x in j.labels]
    assert np.max(np.abs(t.elements - j.elements)) <= 1e-15
    assert t.real == j.real
    assert np.max(np.abs(t.to_elementstd_transform_matrix()
                         - j.to_elementstd_transform_matrix())) <= 1e-15
    if int(round(np.sqrt(t.dim))) ** 2 == t.dim and t.elshape[0] ** 2 == t.dim:
        assert np.max(np.abs(t.create_transform_matrix('std')
                             - j.create_transform_matrix('std'))) <= 1e-15


def _explicit(pkg):
    els = np.random.RandomState(4).randn(4, 2, 2) + 0j
    return pkg.ExplicitBasis(els, ['a', 'b', 'c', 'd'], name='mine')


CLASSES = {
    'explicit': lambda pkg: _explicit(pkg),
    'explicit-unlabelled': lambda pkg: pkg.ExplicitBasis(pkg.BuiltinBasis('gm', 9).elements),
    'tensorprod-pp-pp': lambda pkg: pkg.TensorProdBasis([pkg.BuiltinBasis('pp', 4),
                                                         pkg.BuiltinBasis('pp', 4)]),
    'tensorprod-pp-gm': lambda pkg: pkg.TensorProdBasis([pkg.BuiltinBasis('pp', 4),
                                                         pkg.BuiltinBasis('gm', 9)]),
    'directsum-std': lambda pkg: pkg.DirectSumBasis([pkg.BuiltinBasis('std', 4),
                                                     pkg.BuiltinBasis('std', 1)]),
    'directsum-gm-pp': lambda pkg: pkg.DirectSumBasis([pkg.BuiltinBasis('gm', 9),
                                                       pkg.BuiltinBasis('pp', 4)]),
    'lazy': lambda pkg: pkg.LazyBasis('lazy', lambda: ['x', 'y'],
                                      lambda: pkg.BuiltinBasis('pp', 4).elements[:2]),
}


@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_basis_classes(kind):
    _same_basis(CLASSES[kind](jb), CLASSES[kind](tb))


def test_tensorprod_of_qubits_is_pp():
    """The JAX package's test_baseobjs.py case: pp (x) pp is 2-qubit pp."""
    t = tb.TensorProdBasis([tb.BuiltinBasis('pp', 4), tb.BuiltinBasis('pp', 4)])
    assert np.allclose(t.elements, tb.BuiltinBasis('pp', 16).elements)


@pytest.mark.parametrize("udims", [(2,), (2, 2), (3,), (3, 3), (2, 3)])
def test_default_basis_for_udims(udims):
    j, t = jb.default_basis_for_udims(list(udims)), tb.default_basis_for_udims(list(udims))
    if isinstance(j, str):
        assert t == j
    else:
        _same_basis(j, t)


@pytest.mark.parametrize("a,b", [('pp', 'gm'), ('gm', 'std'), ('std', 'pp')])
def test_transform_between_builtins(a, b):
    dim = 16 if 'pp' in (a, b) else 9
    j = jb.BuiltinBasis(a, dim).create_transform_matrix(jb.BuiltinBasis(b, dim))
    t = tb.BuiltinBasis(a, dim).create_transform_matrix(tb.BuiltinBasis(b, dim))
    assert np.max(np.abs(t - j)) <= 1e-15


def test_basis_constructor_is_cast():
    """Basis.cast of a name is the builtin basis; of a Basis, the basis."""
    pp = tb.Basis.cast('pp', 4)
    assert isinstance(pp, tb.BuiltinBasis) and tb.Basis.cast(pp) is pp
    with pytest.raises(ValueError):
        tb.BuiltinBasis('nope', 4)
    with pytest.raises(ValueError):
        tb.BuiltinBasis('pp', 5)


@pytest.mark.parametrize("blocks", [(2, 1), (1, 2), (2, 2), (3,)])
def test_resize_mx_both_ways(blocks):
    """resize_mx expands a matrix over the blocks' std bases into the whole
    space's std basis and contracts it back, as the JAX package's does."""
    n = sum(b * b for b in blocks)
    D = sum(blocks)
    mx = np.random.RandomState(sum(blocks)).randn(n, n)
    je, te = jbt.resize_mx(mx, list(blocks), 'expand'), tbt.resize_mx(mx, list(blocks), 'expand')
    assert te.shape == (D * D, D * D) and np.max(np.abs(te - je)) <= 1e-15
    big = np.random.RandomState(7).randn(D * D, D * D)
    jc, tc = jbt.resize_mx(big, list(blocks), 'contract'), tbt.resize_mx(big, list(blocks), 'contract')
    assert tc.shape == (n, n) and np.max(np.abs(tc - jc)) <= 1e-15
    assert np.max(np.abs(tbt.resize_mx(te, list(blocks), 'contract') - mx)) <= 1e-15
    assert tbt.resize_mx(mx, None) is mx


def test_resize_std_mx_embeds_blocks_on_their_levels():
    """resize_std_mx goes through the direct-sum basis: a 2 + 1 block
    superoperator lands on the std indices of its levels in the 3-level
    space (the JAX package's resize_std_mx pads with zeros instead:
    ROADMAP.md section 3), and contracts back to itself."""
    ds = tb.DirectSumBasis([tb.BuiltinBasis('std', 4), tb.BuiltinBasis('std', 1)])
    whole = tb.BuiltinBasis('std', 9)
    mx = np.random.RandomState(3).randn(5, 5)
    out = tbt.resize_std_mx(mx, 'expand', ds, whole)
    levels = [0, 1, 3, 4, 8]       # (0,0) (0,1) (1,0) (1,1) of the qubit block, then (2,2)
    assert np.max(np.abs(out[np.ix_(levels, levels)] - mx)) == 0
    assert np.abs(np.delete(np.delete(out, levels, 0), levels, 1)).max() == 0
    assert np.max(np.abs(tbt.resize_std_mx(out, 'contract', whole, ds) - mx)) <= 1e-15
    assert np.max(np.abs(out - jbt.resize_mx(mx, [2, 1], 'expand'))) <= 1e-15
    padded = jbt.resize_std_mx(mx, 'expand', jb.DirectSumBasis(
        [jb.BuiltinBasis('std', 4), jb.BuiltinBasis('std', 1)]), jb.BuiltinBasis('std', 9))
    assert np.max(np.abs(padded[:5, :5] - mx)) == 0 and np.max(np.abs(padded - out)) > 0.1
