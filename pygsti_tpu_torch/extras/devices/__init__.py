"""Device connectivity specs and device-derived models (counterpart of
pygsti_tpu/extras/devices/)."""

from pygsti_tpu_torch.extras.devices.experimentaldevice import (ExperimentalDevice,
                                                                DEVICE_EDGELISTS)
from pygsti_tpu_torch.extras.devices.devcore import (create_processor_spec,
                                                     create_error_rates_model,
                                                     create_local_depolarizing_model,
                                                     edgelist)
