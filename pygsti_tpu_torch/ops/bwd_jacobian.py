"""Per-op gradient binning for the backward half of the blocked Jacobian.

``bwd_jacobian_accumulate`` launches the hand-written CUDA kernel in
``csrc/bwd_jacobian.cu`` (it replaces the Pallas TPU kernel
``pygsti_tpu/ops/pallas_kernels.py: bwd_jacobian_accumulate``) for tensors
on a CUDA device, and runs ``bwd_jacobian_accumulate_plain`` for tensors on
the CPU.  On a CUDA tensor it launches the kernel or raises; it never falls
back to the plain version.  An op index outside ``[0, K1)`` selects no op,
as the JAX reference's one-hot contraction does: that layer adds nothing to
A and zeroes the back-propagated effect.

The kernel keeps the op stack G in a block's shared memory where G takes at
most half of what a block may opt in to and fits beside one layer's buffers
(every 2-qubit and qutrit shape), and reads G from global memory otherwise
(d 64 at 3 qubits; d 16 with more than 56 ops in float64 on an H100).  It
refuses, with ``ValueError``, only a shape whose buffers for one layer
exceed the shared memory a block may opt in to even with G in global
memory.
"""

from __future__ import annotations

import ctypes

import torch

_KERNEL_SYMBOLS = {torch.float64: 'bwd_jacobian_accumulate_f64',
                   torch.float32: 'bwd_jacobian_accumulate_f32'}
_kernels = {}          # dtype -> the ctypes function, resolved once


def bwd_jacobian_accumulate_plain(cols, G, E, F):
    """The scan/einsum form (pygsti_tpu bwd_jacobian_accumulate_reference).

    cols [B, D] int; G [K1, d, d]; E [B, NOUT, d]; F [B, D, d] (state before
    each layer).  Returns (A [B, NOUT, K1, d, d], B_final [B, NOUT, d])."""
    B, D = cols.shape
    K1, d, _ = G.shape
    NOUT = E.shape[1]
    A = torch.zeros((B, NOUT, K1, d, d), dtype=G.dtype, device=G.device)
    ops = torch.arange(K1, device=cols.device)
    Bc = E
    for t in range(D - 1, -1, -1):
        # a comparison, not F.one_hot: an index outside [0, K1) gives a zero row
        onehot = (cols[:, t, None].long() == ops).to(G.dtype)
        A += torch.einsum('bk,bni,bj->bnkij', onehot, Bc, F[:, t])
        yb = torch.einsum('bni,kij->bnkj', Bc, G)
        Bc = torch.einsum('bnkj,bk->bnj', yb, onehot)
    return A, Bc


def _check(cols, G, E, F):
    if cols.dim() != 2 or G.dim() != 3 or E.dim() != 3 or F.dim() != 3:
        raise ValueError("expected cols [B,D], G [K1,d,d], E [B,NOUT,d], "
                         "F [B,D,d]")
    B, D = cols.shape
    K1, d, d2 = G.shape
    if d2 != d or E.shape[0] != B or E.shape[2] != d \
            or tuple(F.shape) != (B, D, d):
        raise ValueError("shape mismatch: cols %s G %s E %s F %s"
                         % (tuple(cols.shape), tuple(G.shape),
                            tuple(E.shape), tuple(F.shape)))
    if cols.dtype != torch.int32:
        raise TypeError("cols must be int32, got %s" % cols.dtype)
    if not (G.dtype == E.dtype == F.dtype):
        raise TypeError("G, E and F must share one dtype")
    devs = {t.device for t in (cols, G, E, F)}
    if len(devs) != 1:
        raise ValueError("all inputs must lie on one device, got %s" % devs)


def _kernel(dtype):
    """The ctypes function of the kernel for ``dtype``, built and bound on
    first use."""
    fn = _kernels.get(dtype)
    if fn is None:
        symbol = _KERNEL_SYMBOLS.get(dtype)
        if symbol is None:
            raise TypeError("the CUDA kernel takes float32 or float64, got %s"
                            % dtype)
        from pygsti_tpu_torch.ops.build import load_library
        fn = getattr(load_library('bwd_jacobian'), symbol)
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _kernels[dtype] = fn
    return fn


def g_in_shared_memory(G, NOUT):
    """Whether the kernel keeps this op stack G [K1, d, d] (on a CUDA
    device) in shared memory for NOUT outcomes (True) or reads it from
    global memory (False); see the module note."""
    if G.device.type != 'cuda':
        raise ValueError("the kernel's route is a property of a CUDA device")
    _kernel(G.dtype)
    from pygsti_tpu_torch.ops.build import load_library
    fn = load_library('bwd_jacobian').bwd_jacobian_g_in_shared
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    K1, d, _ = G.shape
    with torch.cuda.device(G.device):
        r = fn(G.element_size(), K1, d, NOUT)
    if r not in (0, 1):
        raise RuntimeError("bwd_jacobian: CUDA error %d asking the device" % -r)
    return r == 1


def bwd_jacobian_accumulate(cols, G, E, F):
    """(A [B, NOUT, K1, d, d], B_final [B, NOUT, d]); see the module note.

    ``bwd_jacobian_accumulate.launches`` counts kernel launches."""
    _check(cols, G, E, F)
    if G.device.type == 'cpu':
        return bwd_jacobian_accumulate_plain(cols, G, E, F)
    if G.device.type != 'cuda':
        raise ValueError("unsupported device %s" % G.device)
    fn = _kernel(G.dtype)
    for name, t in (('cols', cols), ('G', G), ('E', E), ('F', F)):
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
    B, D = cols.shape
    K1, d, _ = G.shape
    NOUT = E.shape[1]
    if B == 0 or D == 0 or NOUT == 0:     # nothing to launch
        return (torch.zeros((B, NOUT, K1, d, d), dtype=G.dtype, device=G.device),
                E.clone())
    A = torch.empty((B, NOUT, K1, d, d), dtype=G.dtype, device=G.device)
    b_final = torch.empty((B, NOUT, d), dtype=G.dtype, device=G.device)
    args = (cols.data_ptr(), G.data_ptr(), E.data_ptr(), F.data_ptr(),
            A.data_ptr(), b_final.data_ptr(), B, D, K1, d, NOUT)
    with torch.cuda.device(G.device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err < 0:
        raise ValueError("bwd_jacobian: one layer's buffers at d %d, NOUT %d "
                         "(K1 %d) need %d bytes of shared memory even with the "
                         "op stack in global memory, more than one block may "
                         "opt in to on %s (its "
                         "cudaDevAttrMaxSharedMemoryPerBlockOptin)"
                         % (d, NOUT, K1, -err, torch.cuda.get_device_name(G.device)))
    if err != 0:
        raise RuntimeError("bwd_jacobian kernel launch failed: CUDA error %d"
                           % err)
    bwd_jacobian_accumulate.launches += 1
    return A, b_final


bwd_jacobian_accumulate.launches = 0
