"""The blocked Jacobian's chain through Tv packed by op slot
(objectivefns.tv_chain) on a card, at the 3-qubit cell's full shapes: one
row block of 64 circuits x 8 outcomes, 29 op slots of d 64, 570
parameters, the map of the cloud3q_line_hs model over its design's layers.
The packed chain against the dense one, bit for bit between two calls,
and no copy of Jt.

Imports nothing of JAX:
    python -m pytest tests/test_torch_chain_cuda.py --noconftest -q
Without a card the test skips.
"""

import json
import os

import numpy as np
import pytest
import torch

from pygsti_tpu_torch.objectivefns import objectivefns as tof

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def cell_model():
    """The 570-parameter start model of cloud3q_line_hs with its design's
    layers registered."""
    from gstbench import design as gd
    from gstbench.configs import cloud3q_line_hs as cfg_module
    with open(os.path.join(ROOT, 'gstbench', 'configs', 'cloud3q_line_hs.json')) as fh:
        cfg = json.load(fh)
    model = cfg_module.start_model(cfg)
    model.register_circuit_layers(gd.port_circuits(gd.load(os.path.join(ROOT, cfg['design']))))
    return model


@pytest.mark.cuda
def test_packed_chain_at_the_cell_shapes(card):
    model = cell_model()
    n_ops, dim, P = len(model.op_keys), model.dim, model.num_params
    assert (n_ops, dim, P) == (29, 64, 570)
    cols = model.op_param_indices()
    assert sum(len(c) for c in cols) == 2646
    v = torch.as_tensor(0.01 + 0.02 * np.random.RandomState(1).rand(P), device='cuda')
    Tv = model.flat_tensors_jacobian_fn()(v)
    NT = Tv.shape[0]
    assert NT == 119360
    rng = np.random.RandomState(2)
    Jt = torch.as_tensor(rng.randn(64 * 8, NT), device='cuda')
    scale = torch.as_tensor(rng.randn(64 * 8), device='cuda')
    chain = tof.tv_chain(cols, n_ops, dim, P, 'cuda')(Tv)
    first = chain(Jt, scale)          # also takes cuBLAS's workspace
    tof.tv_chain.packed = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = chain(Jt, scale)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    assert tof.tv_chain.packed == 1 and abs(tof.tv_chain.density - 0.2353) < 1e-3
    # a copy of Jt's op part alone would take 487 MB; the chain's own
    # buffers take about 23 MB
    assert extra < Jt.numel() * Jt.element_size() // 10, extra
    assert torch.equal(got, first)
    want = (scale[:, None] * Jt) @ Tv
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
