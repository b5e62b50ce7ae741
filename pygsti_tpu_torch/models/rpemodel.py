"""RPE model construction import-path parity (counterpart of
pygsti_tpu/models/rpemodel.py); implementations in extras/rpe."""

from pygsti_tpu_torch.extras.rpe.rpeconstruction import (create_parameterized_rpe_model,
                                                   create_rpe_angle_circuit_lists)
