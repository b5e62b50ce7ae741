"""The small host files of the port against the JAX package's: tools/
exceptions, listtools, slicetools, typeddict, legacytools, mptools,
pdftools, gatetools, locking, nameddict, metaprogramming, opttools and
profile; baseobjs/exceptions, advancedoptions, protectedarray, smartcache
and unitarygatefunction; the RPE leftovers (circuits/rpecircuits,
data/rpedata, models/rpemodel); ExplicitLayerRules,
transform_composed_model and HasProcessorSpec.  Equal results, or 1e-12
on matrices.
"""

import pickle
import warnings

import numpy as np
import pytest

import pygsti_tpu.modelpacks.smq1Q_XYI as jmp1
from pygsti_tpu.circuits import circuit as jcirc
from pygsti_tpu.circuits import rpecircuits as jrpec
from pygsti_tpu.tools import (gatetools as jgt, listtools as jlt, locking as jlock,
                              pdftools as jpdf, slicetools as jst)

import pygsti_tpu_torch.modelpacks.smq1Q_XYI as tmp1
from pygsti_tpu_torch.baseobjs import advancedoptions, protectedarray, smartcache
from pygsti_tpu_torch.baseobjs import exceptions as bexc
from pygsti_tpu_torch.circuits import rpecircuits as trpec
from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.tools import (exceptions, gatetools, legacytools, listtools, locking,
                                    metaprogramming, mptools, nameddict, opttools, pdftools,
                                    profile, slicetools, typeddict)


def test_exceptions():
    import pygsti_tpu.tools.exceptions as jexc
    names = [n for n in dir(jexc) if not n.startswith('_')]
    assert names == [n for n in dir(exceptions) if not n.startswith('_')]
    for n in names:
        ours, theirs = getattr(exceptions, n), getattr(jexc, n)
        assert [b.__name__ for b in ours.__mro__] == [b.__name__ for b in theirs.__mro__]
    assert exceptions.ForwardSimDiagnosticWarning.enabled is False
    assert bexc.GSTRuntimeError is exceptions.GSTRuntimeError
    assert bexc.GSTValueError is exceptions.GSTValueError


def test_listtools():
    data = [3, 1, 3, 2, 1, 4]
    assert listtools.remove_duplicates(data) == jlt.remove_duplicates(data) == [3, 1, 2, 4]
    pairs = [(1, 'a'), (2, 'a'), (1, 'b')]
    assert listtools.remove_duplicates(pairs, 1) == jlt.remove_duplicates(pairs, 1)
    assert listtools.compute_occurrence_indices(data) == jlt.compute_occurrence_indices(data)
    aliases = {'A': ('x', 'y'), 'B': ('z',)}
    tup = ('A', 'q', 'B', 'A')
    assert listtools.find_replace_tuple(tup, aliases) == jlt.find_replace_tuple(tup, aliases)
    assert listtools.find_replace_tuple_list([tup, ('B',)], aliases) == \
        jlt.find_replace_tuple_list([tup, ('B',)], aliases)
    for n in (0, 1, 4, 6):
        assert list(listtools.sorted_partitions(n)) == list(jlt.sorted_partitions(n))
        assert sorted(listtools.partitions(n)) == sorted(jlt.partitions(n))
        assert list(listtools.partition_into(n, 3)) == list(jlt.partition_into(n, 3))
    assert list(listtools.incd_product(range(2), range(3))) == \
        list(jlt.incd_product(range(2), range(3)))
    nested = [[1, [2, 3]], {'k': [4]}]
    assert listtools.lists_to_tuples(nested) == jlt.lists_to_tuples(nested)
    circs = [Circuit('GxGx'), Circuit('Gy')]
    jcircs = [jcirc.Circuit(c.str) for c in circs]
    alias = {'Gx': Circuit('GyGy')}
    jalias = {'Gx': jcirc.Circuit('GyGy')}
    assert [c.str for c in listtools.apply_aliases_to_circuits(circs, alias)] == \
        [c.str for c in jlt.apply_aliases_to_circuits(jcircs, jalias)]


def test_slicetools():
    for s in (slice(2, 9), slice(0, 0), slice(3, 10, 2)):
        assert slicetools.length(s) == jst.length(s)
        assert slicetools.indices(s) == jst.indices(s)
        assert slicetools.shift(s, 4) == jst.shift(s, 4)
        assert np.array_equal(slicetools.to_array(s), jst.to_array(s))
    assert slicetools.intersect(slice(2, 8), slice(5, 12)) == jst.intersect(slice(2, 8),
                                                                            slice(5, 12))
    assert slicetools.list_to_slice([4, 5, 6]) == jst.list_to_slice([4, 5, 6])
    assert slicetools.list_to_slice([4, 6], require_contiguous=False) == [4, 6]
    with pytest.raises(ValueError):
        slicetools.list_to_slice([4, 6])
    assert slicetools.divide(slice(0, 10), 4) == jst.divide(slice(0, 10), 4)
    assert slicetools.slice_of_slice(slice(1, 3), slice(5, 20)) == \
        jst.slice_of_slice(slice(1, 3), slice(5, 20))
    assert slicetools.intersect_within(slice(2, 8), slice(5, 12)) == \
        jst.intersect_within(slice(2, 8), slice(5, 12))
    a, b = slicetools.intersect_within(slice(2, 8), [1, 3, 7, 9]), \
        jst.intersect_within(slice(2, 8), [1, 3, 7, 9])
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_dicts():
    td = typeddict.TypedDict({'a': 'float'}, [('a', 1.5), ('b', 2)])
    assert dict(pickle.loads(pickle.dumps(td))) == {'a': 1.5, 'b': 2}
    assert pickle.loads(pickle.dumps(td))._types == {'a': 'float'}
    nd = nameddict.NamedDict.create_nested([('L', int), ('germ', str)],
                                           {1: {'Gx': 0.5}, 2: {'Gx': 0.25}})
    assert nd.keyname == 'L' and nd[2].keyname == 'germ' and nd[2]['Gx'] == 0.25
    back = pickle.loads(pickle.dumps(nd))
    assert back == nd and back.keyname == 'L'
    assert nd._flatten([]) == [[('L', 1), ('germ', 'Gx'), ('value', 0.5)],
                               [('L', 2), ('germ', 'Gx'), ('value', 0.25)]]
    opts = advancedoptions.GSTAdvancedOptions({'tolerance': 1e-6})
    assert opts['tolerance'] == 1e-6
    with pytest.raises(ValueError, match='Invalid advanced option'):
        opts['no such option'] = 1


def test_deprecation_and_docstrings():
    @legacytools.deprecate('new_fn')
    def old_fn(x):
        return 2 * x

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        assert old_fn(3) == 6
    assert issubclass(caught[0].category, exceptions.pyGSTiDeprecationWarning)
    assert 'new_fn' in str(caught[0].message)

    @metaprogramming.set_docstring("The doc.")
    def f():
        pass
    assert f.__doc__ == "The doc."


def _add(a, b=0):
    return a + b


def test_mptools_and_pdftools():
    args, kwargs = [(1,), (2,), (3,)], [{'b': 10}, {}, {'b': 1}]
    # serial only: a forked pool in a process that runs JAX's threads can deadlock
    assert mptools.starmap_with_kwargs(_add, 3, 1, args, kwargs) == [11, 2, 4]
    with pytest.raises(ValueError):
        mptools.starmap_with_kwargs(_add, 2, 1, args, kwargs)
    p, q = {'0': 0.7, '1': 0.3}, {'0': 0.5, '2': 0.5}
    assert pdftools.tvd(p, q) == jpdf.tvd(p, q)
    assert pdftools.classical_fidelity(p, q) == jpdf.classical_fidelity(p, q)


def test_gatetools():
    for args in ((0.1, 0.2, -0.3, 0.0), (np.pi / 4, 0, 0, 0.01)):
        assert np.max(np.abs(gatetools.single_qubit_gate(*args)
                             - jgt.single_qubit_gate(*args))) < 1e-12
    kw = dict(xx=0.3, iz=-0.2, yi=0.1)
    assert np.max(np.abs(gatetools.two_qubit_gate(**kw) - jgt.two_qubit_gate(**kw))) < 1e-12


def test_locking():
    circs = [Circuit(('Gxpi2',) * k, (0,)) for k in (1, 2, 3, 5, 9, 17, 33)]
    jcircs = [jcirc.Circuit(c.layertup, c.line_labels) for c in circs]
    for trans in ('log', 'none'):
        ours = locking.histonested_circuitlists(circs, trans=trans)
        theirs = jlock.histonested_circuitlists(jcircs, trans=trans)
        assert [[c.str for c in lst] for lst in ours] == [[c.str for c in lst] for lst in theirs]
    c = Circuit("Gxpi2:0Gypi2:0Gxpi2:0Gxpi2:0Gypi2:0Mdefault@(0)")
    jc = jcirc.Circuit(c.str)
    assert [x.str for x in locking.logspaced_prefix_circuits(c)] == \
        [x.str for x in jlock.logspaced_prefix_circuits(jc)]


def test_opttools_and_profile(tmp_path):
    calls = []

    @opttools.cache_by_hashed_args
    def size(x):
        calls.append(x)
        return len(x)

    assert size((1, 2)) == size((1, 2)) == 2 and calls == [(1, 2)]
    assert size([1]) == size([1]) == 1 and len(calls) == 3      # unhashable: no caching
    times = {}
    with opttools.timed_block('blk', time_dict=times):
        sum(range(1000))
    assert len(times['blk']) == 1 and times['blk'][0] >= 0
    assert len(opttools.time_hash()) == 20

    @profile.profile(filename=str(tmp_path / 'prof'))
    def work():
        return sum(range(100))

    assert work() == 4950 and (tmp_path / 'prof.out.0').exists()


def test_protected_array_and_smartcache():
    mask = np.array([True, False, False])
    pa = protectedarray.ProtectedArray(np.arange(3.0), mask)
    pa[1] = 7.0
    with pytest.raises(ValueError):
        pa[0] = 1.0
    assert np.array_equal(np.asarray(pa), [0.0, 7.0, 2.0]) and pa.shape == (3,)
    assert pa == pa.copy() and pa[2] == 2.0
    assert smartcache.digest({'a': [1, 2], 'b': np.arange(3)}) == \
        smartcache.digest({'b': np.arange(3), 'a': [1, 2]})
    assert smartcache.digest('x') != smartcache.digest('y')
    from pygsti_tpu.baseobjs.smartcache import digest as jdigest
    for obj in ({'a': [1, 2], 'b': np.arange(3)}, 'x', (1.5, None, True)):
        assert smartcache.digest(obj) == jdigest(obj)

    @smartcache.smart_cached
    def add(a, b):
        return a + b
    assert add(1, 2) == add(1, 2) == 3
    assert add.cache.status() == {'hits': 1, 'misses': 1, 'size': 1}


def test_rpe_leftovers():
    ks = [1, 2, 4]
    for name in ('make_rpe_alpha_str_lists_gx_gz', 'make_rpe_epsilon_str_lists_gx_gz',
                 'make_rpe_theta_str_lists_gx_gz'):
        ours, theirs = getattr(trpec, name)(ks), getattr(jrpec, name)(ks)
        assert [[c.str for c in lst] for lst in ours] == [[c.str for c in lst] for lst in theirs]
        assert [[len(c) for c in lst] for lst in ours] == [[len(c) for c in lst] for lst in theirs]
    ours, theirs = trpec.make_rpe_string_list_d(2), jrpec.make_rpe_string_list_d(2)
    assert sorted(ours, key=str) == sorted(theirs, key=str)
    assert [c.str for c in ours['totalStrList']] == [c.str for c in theirs['totalStrList']]
    from pygsti_tpu_torch.data.rpedata import make_rpe_data_set
    from pygsti_tpu_torch.extras.rpe.rpeconstruction import (create_rpe_dataset,
                                                             create_parameterized_rpe_model)
    from pygsti_tpu_torch.models import rpemodel
    assert rpemodel.create_parameterized_rpe_model is create_parameterized_rpe_model
    from pygsti_tpu_torch.extras.rpe.rpeconfig_gxpi2_gypi2_00 import \
        rpeconfig_gxpi2_gypi2_00 as cfg
    from pygsti_tpu_torch.extras.rpe.rpeconstruction import create_rpe_angle_circuits_dict
    model = create_parameterized_rpe_model(np.pi / 2, np.pi / 4, 0.0, 0.01, rpeconfig_inst=cfg)
    circs = create_rpe_angle_circuits_dict(2, cfg)
    a = make_rpe_data_set(model, circs, 100, seed=4, device='cpu')
    b = create_rpe_dataset(model, circs, 100, seed=4, device='cpu')
    assert all(dict(a[c].counts) == dict(b[c].counts) for c in circs['totalCircList'])


def test_layer_rules_and_composed_transform():
    from pygsti_tpu_torch.models.explicitmodel import (ExplicitLayerRules,
                                                       transform_composed_model)
    from pygsti_tpu_torch.models.gaugegroup import FullGaugeGroupElement
    from pygsti_tpu.models.explicitmodel import transform_composed_model as j_tcm
    from pygsti_tpu.models.gaugegroup import FullGaugeGroupElement as JElement
    m, jm = tmp1.target_model('full'), jmp1.target_model('full')
    S = np.eye(4)
    S[1, 1] = 0.9
    S[2, 3] = 0.05
    m2, jm2 = transform_composed_model(m, FullGaugeGroupElement(S)), j_tcm(jm, JElement(S))
    assert np.array_equal(m.to_vector(), jm.to_vector())
    for gl in jm.operations.keys():
        assert np.max(np.abs(m2.operations[gl].dense()
                             - np.asarray(jm2.operations[gl].to_dense()))) < 1e-12
    assert np.max(np.abs(m2.preps['rho0'].dense()
                         - np.asarray(jm2.preps['rho0'].to_dense()))) < 1e-12
    assert np.array_equal(m.to_vector(), tmp1.target_model('full').to_vector())   # a copy
    rules = ExplicitLayerRules()
    gl = list(m.operations.keys())[1]
    assert rules.operation_layer_operator(m, gl, {}) is m.operations[gl]
    assert rules.prep_layer_operator(m, 'rho0', {}) is m.preps['rho0']
    assert rules.povm_layer_operator(m, 'Mdefault', {}) is m.povms['Mdefault']


def test_has_processor_spec():
    from pygsti_tpu_torch.protocols.gst import HasProcessorSpec
    from pygsti_tpu_torch.processors.processorspec import QubitProcessorSpec
    pspec = QubitProcessorSpec(1, ['Gxpi2', 'Gypi2'])
    assert HasProcessorSpec(pspec).processor_spec is pspec
    assert HasProcessorSpec(None).processor_spec is None
    with pytest.raises(NotImplementedError):
        HasProcessorSpec('pspec.json')
