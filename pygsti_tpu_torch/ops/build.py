"""Build the package's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` file has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``pygsti_tpu_torch/_build/``, then
loaded with ``ctypes``.  The library's file name carries a hash of its source
and flags, so an edited source is rebuilt and a stale library is never
loaded.  Nothing here runs when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(_PKG_DIR, '_build')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC')

_loaded = {}


def nvcc_path():
    """The CUDA compiler: ``nvcc`` on PATH, else under /usr/local/cuda."""
    found = shutil.which('nvcc')
    if found:
        return found
    default = '/usr/local/cuda/bin/nvcc'
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of pygsti_tpu_torch "
                       "are built on a machine with the CUDA toolkit")


def library_path(name):
    """Where the built library for ``csrc/<name>.cu`` lives."""
    with open(os.path.join(CSRC_DIR, name + '.cu'), 'rb') as fh:
        h = hashlib.sha1(fh.read())
    h.update(' '.join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, 'lib%s_%s.so' % (name, h.hexdigest()[:12]))


def start_build(name):
    """Start ``nvcc`` for one source; returns (Popen or None, tmp, target).
    None means the library is already built.  Several builds may run at
    once: call :func:`finish_build` on each."""
    target = library_path(name)
    if os.path.exists(target):
        return None, None, target
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, '-Xptxas', '-v', '-o', tmp,
           os.path.join(CSRC_DIR, name + '.cu')]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def finish_build(proc, tmp, target):
    """Wait for a build started by :func:`start_build`; returns the
    compiler's output (with ``-Xptxas -v`` register and shared-memory use)."""
    if proc is None:
        return ''
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError("nvcc failed for %s:\n%s" % (target, out))
    os.replace(tmp, target)
    return out


def load_library(name):
    """The ctypes handle of ``csrc/<name>.cu``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        finish_build(*start_build(name))
        lib = ctypes.CDLL(library_path(name))
        _loaded[name] = lib
    return lib
