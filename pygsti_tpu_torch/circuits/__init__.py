"""Circuits, circuit lists and structures, and their construction
(counterpart of pygsti_tpu/circuits)."""

from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.circuits.circuitlist import CircuitList
from pygsti_tpu_torch.circuits.circuitparser import parse_circuit_str, parse_label_str
from pygsti_tpu_torch.circuits.gstcircuits import (
    create_lsgst_circuit_lists, create_lsgst_circuits, create_lgst_circuits,
    create_elgst_lists, create_elgst_experiment_list, make_lsgst_structs,
    repeat_with_max_length, repeat_and_truncate)
from pygsti_tpu_torch.circuits.circuitstructure import (
    CircuitPlaquette, FiducialPairPlaquette, GermFiducialPairPlaquette,
    PlaquetteGridCircuitStructure)
from pygsti_tpu_torch.circuits import circuitconstruction
from pygsti_tpu_torch.circuits.circuitconstruction import (
    to_circuits, list_all_circuits, iter_all_circuits,
    list_all_circuits_without_powers_and_cycles, translate_circuits)
from pygsti_tpu_torch.circuits import cloudcircuitconstruction
from pygsti_tpu_torch.circuits.cloudcircuitconstruction import (
    create_cloudnoise_circuits, create_kcoverage_template)
