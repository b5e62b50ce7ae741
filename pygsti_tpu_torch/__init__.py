"""pygsti_tpu_torch -- the PyTorch and CUDA port of pygsti_tpu, for NVIDIA Hopper.

The port keeps the JAX package's module layout and names, so each module
here has a counterpart of the same path under ``pygsti_tpu/``.  It imports
torch, numpy and scipy, and nothing of JAX or of ``pygsti_tpu``.  Plain
tensor work is PyTorch; the one hand-written kernel of the GST fit's path,
the backward accumulation of the blocked Jacobian, is CUDA C++ for
``sm_90a`` (``csrc/bwd_jacobian.cu``).

Entry points take ``device=`` (default ``"cuda"``); pass ``"cpu"`` to run
the plain PyTorch versions of the kernels.
"""

import torch as _torch

# GST is a precision instrument: lowered float32 matmul precision stalled LM
# convergence on the TPU (pygsti_tpu/__init__.py), so TF32 stays off for
# every product, cuDNN's included.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

#: dtype of model tensors, probabilities, the Jacobian and the LM solve.  The
#: H100 has native float64, so the port keeps the JAX package's off-TPU
#: default (float64 model and Jacobian).
DTYPE = _torch.float64

__version__ = "0.1.0"
