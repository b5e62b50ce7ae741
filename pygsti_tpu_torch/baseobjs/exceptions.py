"""Import-path parity for the GST exceptions (counterpart of
pygsti_tpu/baseobjs/exceptions.py); canonical home is tools/exceptions."""

from pygsti_tpu_torch.tools.exceptions import GSTRuntimeError, GSTValueError
