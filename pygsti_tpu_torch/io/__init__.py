"""Text formats and directories in and out (counterpart of pygsti_tpu/io)."""

from pygsti_tpu_torch.io.readers import (read_dataset, read_circuit_list, load_dataset,
                                         load_circuit_list, read_multidataset,
                                         load_multidataset, read_time_dependent_dataset)
from pygsti_tpu_torch.io.writers import (write_dataset, write_circuit_list, write_multidataset,
                                         write_empty_dataset)
from pygsti_tpu_torch.io.stdinput import StdInputParser
from pygsti_tpu_torch.io import metadir
from pygsti_tpu_torch.io import mongodb
