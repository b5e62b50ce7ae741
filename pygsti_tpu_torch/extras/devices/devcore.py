"""Device-spec helpers: processor specs and calibration-derived models
(counterpart of pygsti_tpu/extras/devices/devcore.py).  Host work only.
"""

from __future__ import annotations

import numpy as np

from pygsti_tpu_torch.baseobjs.label import Label
from pygsti_tpu_torch.extras.devices.experimentaldevice import (ExperimentalDevice,
                                                          DEVICE_EDGELISTS)


def _cast_device(device):
    if isinstance(device, ExperimentalDevice):
        return device
    return ExperimentalDevice.from_legacy_device(device)


def get_device_specs(devname):
    """Deprecated alias of basic_device_information."""
    return basic_device_information(devname)


def edgelist(device):
    """Device edge list."""
    return list(_cast_device(device).graph.edges())


def create_processor_spec(device, one_qubit_gates, qubitsubset=None,
                          removeedges=()):
    """QubitProcessorSpec for the device."""
    dev = _cast_device(device)
    gate_names = list(one_qubit_gates) + list(dev.gate_mapping.keys())
    return dev.create_processor_spec(gate_names, qubitsubset,
                                     list(removeedges))


def _agi_to_ei(agi, nq):
    """Average gate infidelity -> entanglement infidelity."""
    d = 2 ** nq
    return (d + 1) / d * agi


def create_error_rates_model(caldata, device, one_qubit_gates=('Gxpi2', 'Gypi2'),
                             one_qubit_gates_to_native=None, calformat='native',
                             model_type='TwirledLayers', idle_name=None):
    """Opless error-rates model from calibration data.

    'native' calformat: caldata = {'gates': {key: rate}, 'readout':
    {qubit: rate}} used directly.  One- and two-qubit gate error rates become
    per-gate error rates keyed by qubit (1Q) or edge label (2Q).
    """
    from pygsti_tpu_torch.models.oplessmodel import (TwirledLayersModel, TwirledGatesModel,
                                                     AnyErrorCausesFailureModel,
                                                     AnyErrorCausesRandomOutputModel)
    dev = _cast_device(device)
    nq = len(dev.qubits)

    if caldata is None:
        caldata = {'gates': {}, 'readout': {}}
    if calformat == 'native':
        error_rates = {'gates': dict(caldata.get('gates', {})),
                       'readout': dict(caldata.get('readout', {}))}
    elif calformat in ('ibmq-v2018', 'ibmq-v2019'):
        # backend.properties().to_dict() format: per-qubit/per-gate AGIs
        error_rates = {'gates': {}, 'readout': {}}
        for g in caldata.get('gates', []):
            name = g.get('gate')
            qubits = g.get('qubits', [])
            err = next((p['value'] for p in g.get('parameters', [])
                        if p.get('name') == 'gate_error'), None)
            if err is None:
                continue
            if len(qubits) == 2:
                key = frozenset(('Q%d' % qubits[0], 'Q%d' % qubits[1]))
                error_rates['gates'][key] = _agi_to_ei(float(err), 2)
            elif len(qubits) == 1 and name not in ('id', 'reset'):
                error_rates['gates']['Q%d' % qubits[0]] = \
                    _agi_to_ei(float(err), 1)
        for i, qd in enumerate(caldata.get('qubits', [])):
            ro = next((p['value'] for p in qd
                       if p.get('name') == 'readout_error'), None)
            if ro is not None:
                error_rates['readout']['Q%d' % i] = float(ro)
    else:
        raise ValueError("Unknown calformat %r" % calformat)

    # alias every concrete circuit-layer label to its rate key: 1Q gate on
    # qubit q -> q; 2Q gate on (q1, q2) -> frozenset edge key
    alias = {}
    for q in dev.qubits:
        for g1 in one_qubit_gates:
            alias[Label(g1, (q,))] = q
        error_rates['gates'].setdefault(q, 0.0)
    for (q1, q2) in dev.graph.edges():
        key = frozenset((q1, q2))
        for g2 in dev.gate_mapping.keys():
            alias[Label(g2, (q1, q2))] = key
            alias[Label(g2, (q2, q1))] = key
        error_rates['gates'].setdefault(key, 0.0)
    for q in dev.qubits:
        error_rates['readout'].setdefault(q, 0.0)
    if idle_name is not None:
        for q in dev.qubits:
            alias[Label(idle_name, (q,))] = q

    cls = {'TwirledLayers': TwirledLayersModel,
           'TwirledGates': TwirledGatesModel,
           'AnyErrorCausesFailure': AnyErrorCausesFailureModel,
           'AnyErrorCausesRandomOutput': AnyErrorCausesRandomOutputModel}[model_type]
    return cls(error_rates, nq, alias_dict=alias, idle_name=idle_name)


def create_local_depolarizing_model(caldata, device,
                                    one_qubit_gates=('Gxpi2', 'Gypi2'),
                                    one_qubit_gates_to_native=None,
                                    calformat='native', qubits=None):
    """Crosstalk-free model with per-gate depolarization from calibration
    data.  `calformat` supports the 'native'
    calibration-dict layout only (other formats raise);
    `one_qubit_gates_to_native` optionally renames calibration gate keys to
    native names; `qubits` restricts the device to a qubit subset."""
    from pygsti_tpu_torch.models.modelconstruction import create_crosstalk_free_model
    if calformat != 'native':
        raise NotImplementedError(
            "calformat=%r is not supported (only 'native' calibration "
            "dicts)" % (calformat,))
    if one_qubit_gates_to_native:
        caldata = dict(caldata or {})
        gcal = dict(caldata.get('gates', {}))
        for src, dst in one_qubit_gates_to_native.items():
            if src in gcal:
                gcal[dst] = gcal.pop(src)
        caldata['gates'] = gcal
    dev = _cast_device(device)
    if qubits is not None:
        pspec = create_clifford_processor_spec(dev, one_qubit_gates,
                                               qubitsubset=qubits)
    else:
        pspec = create_processor_spec(dev, one_qubit_gates)
    rates = {}
    gates_cal = (caldata or {}).get('gates', {})
    for g1 in one_qubit_gates:
        vals = [v for k, v in gates_cal.items() if not isinstance(k, frozenset)]
        if vals:
            rates[g1] = float(np.mean(vals))
    for g2 in dev.gate_mapping.keys():
        vals = [v for k, v in gates_cal.items() if isinstance(k, frozenset)]
        if vals:
            rates[g2] = float(np.mean(vals))
    return create_crosstalk_free_model(pspec, depolarization_strengths=rates)


def basic_device_information(devname):
    """The device spec (qubit list, edge list, 2Q gate) for a known device
    name."""
    return _cast_device(devname)


def create_clifford_processor_spec(device, one_qubit_gates, qubitsubset=None,
                                   removeedges=(),
                                   clifford_compilation_type='absolute',
                                   what_to_compile=('1Qcliffords',),
                                   verbosity=0):
    """A processor spec for `device` with Clifford compilations attached
   .  Our
    CompilationRules compile on demand, so this returns the same pspec as
    create_processor_spec."""
    return create_processor_spec(device, one_qubit_gates,
                                 qubitsubset=qubitsubset,
                                 removeedges=removeedges)
