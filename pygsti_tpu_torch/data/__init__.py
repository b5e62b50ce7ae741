"""Data sets and their simulation (counterpart of pygsti_tpu/data)."""

from pygsti_tpu_torch.data.dataset import DataSet
from pygsti_tpu_torch.data.datasetconstruction import simulate_data
from pygsti_tpu_torch.data.multidataset import MultiDataSet
