"""The port's public namespaces against the JAX package's.

Every public name of each namespace of ``pygsti_tpu`` -- the attributes its
``__init__`` exposes and the modules of its package -- is in the
counterpart namespace of ``pygsti_tpu_torch``, as the same kind of object
(module, class, function), except the names listed in NOT_PORTED (each
with its ROADMAP.md queue 1 item; empty now that every item is ported) and
DELIBERATELY_ABSENT: the test holds every listed name absent from the
port.
"""

import importlib
import inspect
import pkgutil
import subprocess
import sys

import pytest

import pygsti_tpu  # noqa: F401  (the whole JAX package, as a user imports it)
import pygsti_tpu_torch  # noqa: F401

NAMESPACES = ['', 'algorithms', 'baseobjs', 'circuits', 'data', 'extras', 'forwardsims',
              'layouts', 'modelmembers', 'models', 'objectivefns', 'optimize', 'protocols',
              'tools', 'processors', 'io', 'serialization', 'drivers', 'ops',
              'extras.crosstalk', 'extras.devices', 'extras.ibmq', 'extras.idletomography',
              'extras.interpygate', 'extras.lfh', 'extras.paritybenchmarking', 'report']

# name -> the ROADMAP.md queue 1 item that ports it (every item is ported)
NOT_PORTED = {}

# not carried over on purpose (ROADMAP.md queue 1, "Deliberately not carried over")
DELIBERATELY_ABSENT = {
    'tools.jitutils': "hides XLA compile time",
    'ops.load_fastparser': "a host-C++ loader: the port's circuit parser is pure Python",
    'ops.load_fastopcalc': "a host-C++ loader of the JAX package's op calculus",
}


def _module(pkg, ns):
    return importlib.import_module(pkg + ('.' + ns if ns else ''))


def _public_names(ns):
    """The JAX namespace's public names: its attributes other than modules,
    and the modules of its package (ops' modules are the kernels, ported
    under other names, so only its functions count)."""
    mod = _module('pygsti_tpu', ns)
    names = {n for n in dir(mod) if not n.startswith('_') and not inspect.ismodule(getattr(mod, n))}
    if ns != 'ops':
        names |= {m.name for m in pkgutil.iter_modules(mod.__path__) if not m.name.startswith('_')}
        if ns == '':
            names |= {'alg', 'mm', 'rpt'}       # module aliases
    return names


def _port_attr(ns, name):
    """The port's object of that name, or None."""
    mod = _module('pygsti_tpu_torch', ns)
    if hasattr(mod, name):
        return getattr(mod, name)
    try:
        return importlib.import_module(mod.__name__ + '.' + name)
    except ImportError:
        return None


def _jax_attr(ns, name):
    mod = _module('pygsti_tpu', ns)
    if hasattr(mod, name):
        return getattr(mod, name)
    return importlib.import_module(mod.__name__ + '.' + name)


def _kind(obj):
    if inspect.ismodule(obj):
        return 'module'
    if inspect.isclass(obj):
        return 'class'
    return 'function' if callable(obj) else 'value'


def _key(ns, name):
    return (ns + '.' if ns else '') + name


@pytest.mark.parametrize("ns", NAMESPACES)
def test_every_public_name_is_ported(ns):
    absent = sorted(n for n in _public_names(ns)
                    if _key(ns, n) not in NOT_PORTED and _key(ns, n) not in DELIBERATELY_ABSENT
                    and _port_attr(ns, n) is None)
    assert not absent, "pygsti_tpu_torch%s lacks %s" % ('.' + ns if ns else '', absent)


@pytest.mark.parametrize("ns", NAMESPACES)
def test_names_are_of_the_same_kind(ns):
    differ = []
    for n in sorted(_public_names(ns)):
        ours = _port_attr(ns, n)
        if ours is not None and _kind(ours) != _kind(_jax_attr(ns, n)):
            differ.append((n, _kind(_jax_attr(ns, n)), _kind(ours)))
    assert not differ, differ


@pytest.mark.parametrize("key", sorted(NOT_PORTED) + sorted(DELIBERATELY_ABSENT))
def test_listed_names_are_public_in_jax_and_absent_here(key):
    ns, _, name = key.rpartition('.')
    assert name in _public_names(ns), "%s is no public name of the JAX package" % key
    assert _port_attr(ns, name) is None, \
        "%s is ported now: take it off the test's list and ROADMAP.md's" % key


def test_not_ported_items_are_later_queue_items():
    """The list is empty: queue 1 items 1-10 are ported."""
    assert NOT_PORTED == {}


# the names of queue 1 items 9 and 10, the last on the list
PORTED_LAST = {
    'forwardsims.ForwardSimulator': 9, 'forwardsims.MapForwardSimulator': 9,
    'forwardsims.MatrixForwardSimulator': 9, 'forwardsims.TorchForwardSimulator': 9,
    'forwardsims.create_forward_simulator': 9, 'forwardsims.mapforwardsim': 9,
    'forwardsims.matrixforwardsim': 9, 'forwardsims.torchfwdsim': 9,
    'layouts.prodcache': 9, 'models.explicitcalc': 9,
    'parallel': 10, 'forwardsims.distforwardsim': 10, 'tools.launchtools': 10,
    'tools.mpitools': 10, 'tools.sharedmemtools': 10, 'baseobjs.resourceallocation': 10,
}


@pytest.mark.parametrize("key", sorted(PORTED_LAST))
def test_last_listed_names_are_ported(key):
    """Each name of items 9 and 10 is public in the JAX package and in the
    port, as the same kind of object."""
    ns, _, name = key.rpartition('.')
    assert name in _public_names(ns)
    ours = _port_attr(ns, name)
    assert ours is not None and _kind(ours) == _kind(_jax_attr(ns, name))


def test_top_level_names_are_the_jax_packages():
    import pygsti_tpu as j
    import pygsti_tpu_torch as t
    assert t.alg is t.algorithms and t.mm is t.modelmembers
    assert t.Circuit is t.circuits.Circuit and t.Label is t.baseobjs.Label
    assert t.DataSet is t.data.DataSet and t.simulate_data is t.data.simulate_data
    assert t.tools.fidelity is t.tools.optools.fidelity
    assert t.Circuit("Gxpi2:0Gypi2:0@(0)") == t.Circuit([("Gxpi2", 0), ("Gypi2", 0)], (0,))
    assert str(t.Circuit("Gxpi2:0Gypi2:0@(0)")) == str(j.Circuit("Gxpi2:0Gypi2:0@(0)"))


def test_import_loads_no_jax_and_no_cuda_context():
    """In a fresh process, ``import pygsti_tpu_torch`` (every namespace)
    imports no jax and no pygsti_tpu module, builds no kernel and leaves
    CUDA uninitialized."""
    code = ("import sys, time\n"
            "t0 = time.perf_counter()\n"
            "import pygsti_tpu_torch, torch\n"
            "from pygsti_tpu_torch.protocols import GateSetTomography\n"
            "from pygsti_tpu_torch.ops import build, bwd_jacobian\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'pygsti_tpu')]\n"
            "assert not bad, bad\n"
            "assert not torch.cuda.is_initialized()\n"
            "assert not bwd_jacobian._kernels and not build._loaded\n"
            "print('ok %.3f' % (time.perf_counter() - t0))\n")
    out = subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                         capture_output=True, text=True).stdout
    assert out.strip().splitlines()[-1].startswith('ok ')
