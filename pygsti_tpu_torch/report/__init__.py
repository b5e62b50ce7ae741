"""Reporting: reportable metrics and HTML report generation (counterpart of
pygsti_tpu/report/)."""

from pygsti_tpu_torch.report import reportables
from pygsti_tpu_torch.report.factory import construct_standard_report, Report
from pygsti_tpu_torch.report.fogidiagram import FOGIDiagram
from pygsti_tpu_torch.report import vbplot
from pygsti_tpu_torch.report.modelfunction import ModelFunction, modelfn_factory
from pygsti_tpu_torch.report import colormaps
from pygsti_tpu_torch.report.reportableqty import ReportableQty
