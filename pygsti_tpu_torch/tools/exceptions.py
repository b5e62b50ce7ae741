"""Exception and warning types (counterpart of pygsti_tpu/tools/exceptions.py).

These are the canonical warning/exception classes raised throughout the
package; `pygsti_tpu_torch.baseobjs.exceptions` re-exports the two GST errors
for import-path parity with the reference.
"""


class GSTRuntimeError(Exception):
    """Raised when a GST computation fails at runtime (reference :14)."""


class GSTValueError(Exception):
    """Raised for invalid values passed to GST entry points (reference :21)."""


class MissingDependencyWarning(UserWarning):
    """An optional dependency is missing; a fallback path was used."""


class DeprecatedPositionalArgumentsWarning(UserWarning):
    """Positional arguments used where keyword arguments are now required."""


class NumericalDomainWarning(UserWarning):
    """A numerical quantity left its mathematically valid domain."""


class ProbabilityClippingWarning(NumericalDomainWarning):
    """Probabilities were clipped into [0, 1]."""


class pyGSTiDeprecationWarning(UserWarning, DeprecationWarning):
    """A deprecated pyGSTi API was used."""


class ImplicitlyDoneEditingCircuitWarning(UserWarning):
    """An editable circuit was implicitly finalized."""


class PrepareThyself(UserWarning):
    """An object needed implicit preparation before use."""


class UnknownGaugeSpaceDimension(UserWarning):
    """The gauge-space dimension could not be determined."""


class CVXPYFailure(UserWarning):
    """A CVXPY solve failed; results may use a fallback."""


class UntouchedModelNoiseKey(UserWarning):
    """A model-noise specification key was never consumed."""


class OverparameterizationWarning(UserWarning):
    """A model has more parameters than the data can constrain."""


class UnnamedReportWarning(UserWarning):
    """A report was generated without an explicit name."""


class StolenResourceWarning(UserWarning):
    """A resource allocation was taken over by another consumer."""


class DubiousTargetWarning(UserWarning):
    """A target model looks inconsistent with the request."""


class QiskitInteropWarning(UserWarning):
    """Qiskit interoperability hit a best-effort conversion."""


class ForwardSimDiagnosticWarning(UserWarning):
    """A forward simulator reported a diagnostic condition.

    Emit sites guard on the class-level `enabled` flag, so these diagnostics
    are suppressed by default (reference baseobjs/exceptions.py contract).
    """
    enabled = False


class ClobberingWarning(UserWarning):
    """An existing file or entry was overwritten."""
