"""Per-op gradient binning for the backward half of the blocked Jacobian.

``bwd_jacobian_accumulate`` launches the hand-written CUDA kernel in
``csrc/bwd_jacobian.cu`` (it replaces the Pallas TPU kernel
``pygsti_tpu/ops/pallas_kernels.py: bwd_jacobian_accumulate``) for tensors
on a CUDA device, and runs ``bwd_jacobian_accumulate_plain`` for tensors on
the CPU.  On a CUDA tensor it launches the kernel or raises; it never falls
back to the plain version.  An op index outside ``[0, K1)`` selects no op,
as the JAX reference's one-hot contraction does: that layer adds nothing to
A and zeroes the back-propagated effect.

Given ``out`` [B, NOUT, R] (contiguous, R >= (K1 - 1) d^2), the op blocks
A[b, n, k] for k < K1 - 1 land at ``out[b, n, k d^2:(k + 1) d^2]`` (the
last slot, the identity that pads short circuits, is not written, and the
rest of each row is left as it was), so a caller can have them written
straight into its Jacobian's rows.

The kernel has two routes (the source's note).  Where the op stack G takes
at most half the shared memory a block may opt in to and fits beside one
layer's buffers (every 2-qubit and qutrit shape), one kernel keeps G in
shared memory.  Otherwise (d 64 at 3 qubits; d 16 with more than 56 ops in
float64 on an H100) two kernels run: the chain writes every back-propagated
effect to a scratch stash [B, D, NOUT, d] in device memory, which the
wrapper allocates, and a grid over tiles of A writes each value of A once.
Both are bound by the bytes of A.  The one call counts one launch whichever
route it takes.  Only a shape whose one row of G and of the effects (twice
each) exceed the shared memory a block may opt in to (d past 7,264 in
float64 on an H100) is refused, with ``ValueError``.
"""

from __future__ import annotations

import ctypes

import torch

_KERNEL_SYMBOLS = {torch.float64: 'bwd_jacobian_accumulate_f64',
                   torch.float32: 'bwd_jacobian_accumulate_f32'}
_kernels = {}          # dtype -> the ctypes function, resolved once
_routes = {}           # (device, dtype, K1, d, NOUT) -> G in shared memory


def bwd_jacobian_accumulate_plain(cols, G, E, F, out=None):
    """The scan/einsum form (pygsti_tpu bwd_jacobian_accumulate_reference).

    cols [B, D] int; G [K1, d, d]; E [B, NOUT, d]; F [B, D, d] (state before
    each layer).  Returns (A [B, NOUT, K1, d, d], B_final [B, NOUT, d]), or
    (out, B_final) with the op blocks written into ``out`` (module note)."""
    B, D = cols.shape
    K1, d, _ = G.shape
    NOUT = E.shape[1]
    if out is not None:
        _check_out(out, B, NOUT, K1, d, G)
    A = torch.zeros((B, NOUT, K1, d, d), dtype=G.dtype, device=G.device)
    ops = torch.arange(K1, device=cols.device)
    Bc = E
    for t in range(D - 1, -1, -1):
        # a comparison, not F.one_hot: an index outside [0, K1) gives a zero row
        onehot = (cols[:, t, None].long() == ops).to(G.dtype)
        A += torch.einsum('bk,bni,bj->bnkij', onehot, Bc, F[:, t])
        yb = torch.einsum('bni,kij->bnkj', Bc, G)
        Bc = torch.einsum('bnkj,bk->bnj', yb, onehot)
    if out is None:
        return A, Bc
    out[:, :, :(K1 - 1) * d * d] = A[:, :, :K1 - 1].reshape(B, NOUT, (K1 - 1) * d * d)
    return out, Bc


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


def _check_out(out, B, NOUT, K1, d, G):
    if out.dim() != 3 or tuple(out.shape[:2]) != (B, NOUT) \
            or out.shape[2] < (K1 - 1) * d * d:
        raise ValueError("out must be [B, NOUT, R] = [%d, %d, >= %d], got %s"
                         % (B, NOUT, (K1 - 1) * d * d, tuple(out.shape)))
    if out.dtype != G.dtype:
        raise TypeError("out must be %s like G, got %s" % (G.dtype, out.dtype))
    if out.device != G.device:
        raise ValueError("out must lie on %s with the inputs, got %s"
                         % (G.device, out.device))
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")


def _library():
    """The kernel's library, built and its functions typed on first use."""
    from pygsti_tpu_torch.ops.build import load_library
    lib = load_library('bwd_jacobian')
    if not _kernels:
        for dtype, symbol in _KERNEL_SYMBOLS.items():
            fn = getattr(lib, symbol)
            fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                           + [ctypes.c_longlong, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _kernels[dtype] = fn
        lib.bwd_jacobian_g_in_shared.argtypes = [ctypes.c_int] * 4
        lib.bwd_jacobian_g_in_shared.restype = ctypes.c_int
    return lib


def _kernel(dtype):
    """The ctypes function of the kernel for ``dtype``."""
    if dtype not in _KERNEL_SYMBOLS:
        raise TypeError("the CUDA kernel takes float32 or float64, got %s"
                        % dtype)
    _library()
    return _kernels[dtype]


def g_in_shared_memory(G, NOUT):
    """Whether the kernel keeps this op stack G [K1, d, d] (on a CUDA
    device) in shared memory for NOUT outcomes (True) or takes the
    two-stage route (False); see the module note."""
    if G.device.type != 'cuda':
        raise ValueError("the kernel's route is a property of a CUDA device")
    _kernel(G.dtype)
    K1, d, _ = G.shape
    key = (G.device, G.dtype, K1, d, NOUT)
    shared = _routes.get(key)
    if shared is None:
        with torch.cuda.device(G.device):
            r = _library().bwd_jacobian_g_in_shared(G.element_size(), K1, d, NOUT)
        if r not in (0, 1):
            raise RuntimeError("bwd_jacobian: CUDA error %d asking the device" % -r)
        shared = _routes[key] = r == 1
    return shared


def bwd_jacobian_accumulate(cols, G, E, F, out=None):
    """(A [B, NOUT, K1, d, d], B_final [B, NOUT, d]), or (out, B_final)
    with the op blocks written into ``out``; see the module note.

    ``bwd_jacobian_accumulate.launches`` counts calls that launched the
    kernel (one per call, on either route)."""
    _check(cols, G, E, F)
    if G.device.type == 'cpu':
        return bwd_jacobian_accumulate_plain(cols, G, E, F, out)
    if G.device.type != 'cuda':
        raise ValueError("unsupported device %s" % G.device)
    fn = _kernel(G.dtype)
    for name, t in (('cols', cols), ('G', G), ('E', E), ('F', F)):
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
    B, D = cols.shape
    K1, d, _ = G.shape
    NOUT = E.shape[1]
    if out is not None:
        _check_out(out, B, NOUT, K1, d, G)
    if B == 0 or D == 0 or NOUT == 0:     # nothing to launch
        if out is None:
            return (torch.zeros((B, NOUT, K1, d, d), dtype=G.dtype, device=G.device),
                    E.clone())
        out[:, :, :(K1 - 1) * d * d] = 0
        return out, E.clone()
    if out is None:
        A = torch.empty((B, NOUT, K1, d, d), dtype=G.dtype, device=G.device)
        Kw, rowstride = K1, K1 * d * d
    else:
        A, Kw, rowstride = out, K1 - 1, out.shape[2]
    b_final = torch.empty((B, NOUT, d), dtype=G.dtype, device=G.device)
    stash = None if g_in_shared_memory(G, NOUT) else torch.empty(
        (B, D, NOUT, d), dtype=G.dtype, device=G.device)
    args = (cols.data_ptr(), G.data_ptr(), E.data_ptr(), F.data_ptr(),
            A.data_ptr(), b_final.data_ptr(),
            None if stash is None else stash.data_ptr(),
            B, D, K1, d, NOUT, Kw, rowstride)
    with torch.cuda.device(G.device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err < 0:
        raise ValueError("bwd_jacobian: one row of the op stack and of the "
                         "effects at d %d (twice each, %s) need %d bytes of "
                         "shared memory, more than one block may opt in to "
                         "on %s (its cudaDevAttrMaxSharedMemoryPerBlockOptin)"
                         % (d, G.dtype, -err, torch.cuda.get_device_name(G.device)))
    if err != 0:
        raise RuntimeError("bwd_jacobian kernel launch failed: CUDA error %d"
                           % err)
    bwd_jacobian_accumulate.launches += 1
    return A, b_final


bwd_jacobian_accumulate.launches = 0
