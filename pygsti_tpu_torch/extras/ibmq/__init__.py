"""IBM Q interface (counterpart of pygsti_tpu/extras/ibmq/).

Submission needs qiskit / qiskit-ibm-runtime; the experiment container and
its checkpoints work without them, so designs can be staged and results
ingested offline.
"""

from pygsti_tpu_torch.extras.ibmq.ibmqexperiment import IBMQExperiment
