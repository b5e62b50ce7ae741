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

# The namespaces of the JAX package's top level (pyGSTi's).  Modules import
# DTYPE from here, so the subpackages come after it.  No import builds a
# kernel or touches a CUDA context: a kernel builds at its first launch.
from pygsti_tpu_torch import baseobjs  # noqa: E402
from pygsti_tpu_torch import tools  # noqa: E402
from pygsti_tpu_torch import circuits  # noqa: E402
from pygsti_tpu_torch import processors  # noqa: E402
from pygsti_tpu_torch import modelmembers  # noqa: E402
from pygsti_tpu_torch import models  # noqa: E402
from pygsti_tpu_torch import layouts  # noqa: E402
from pygsti_tpu_torch import forwardsims  # noqa: E402
from pygsti_tpu_torch import objectivefns  # noqa: E402
from pygsti_tpu_torch import optimize  # noqa: E402
from pygsti_tpu_torch import algorithms  # noqa: E402
from pygsti_tpu_torch import data  # noqa: E402
from pygsti_tpu_torch import protocols  # noqa: E402
from pygsti_tpu_torch import drivers  # noqa: E402
from pygsti_tpu_torch import io  # noqa: E402
from pygsti_tpu_torch import report  # noqa: E402
from pygsti_tpu_torch import serialization  # noqa: E402
from pygsti_tpu_torch import leakage  # noqa: E402

# pyGSTi's short aliases
from pygsti_tpu_torch import algorithms as alg  # noqa: E402
from pygsti_tpu_torch import modelmembers as mm  # noqa: E402
from pygsti_tpu_torch import report as rpt  # noqa: E402

from pygsti_tpu_torch.algorithms.core import run_lgst, run_iterative_gst  # noqa: E402
from pygsti_tpu_torch.algorithms.gaugeopt import gaugeopt_to_target  # noqa: E402
from pygsti_tpu_torch.algorithms.contract import contract  # noqa: E402
from pygsti_tpu_torch.algorithms.grammatrix import (max_gram_basis,  # noqa: E402
                                                    max_gram_rank_and_eigenvalues)

from pygsti_tpu_torch.baseobjs.label import Label  # noqa: E402
from pygsti_tpu_torch.circuits.circuit import Circuit  # noqa: E402
from pygsti_tpu_torch.data.dataset import DataSet  # noqa: E402
from pygsti_tpu_torch.data.datasetconstruction import simulate_data  # noqa: E402

from pygsti_tpu_torch.drivers.longsequence import (run_long_sequence_gst,  # noqa: E402
                                                   run_stdpractice_gst, run_model_test,
                                                   run_linear_gst)
