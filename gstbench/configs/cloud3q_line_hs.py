"""A 3-qubit cloud-noise crosstalk model on a line, Lindblad 'H+s' clouds
and 'H+S' SPAM: the program's constructor and its plain reference
(reference/models.py CloudNoise)."""

from gstbench.reference.models import CloudNoise, cloud_truth


def reference(cfg):
    return CloudNoise(cfg)


def truth(cfg, ref):
    """The data's truth: every parameter 0.002 |N(0, 1)| from
    RandomState(16), the idle's H_X on qubit 0 planted at 0.03."""
    return cloud_truth(ref, cfg)


def _spec(cfg):
    from pygsti_tpu_torch.processors.processorspec import QubitProcessorSpec
    return QubitProcessorSpec(cfg['qubits'], [g for g, _ in cfg['gates']],
                              geometry=cfg['geometry'])


def start_model(cfg):
    """The program's fit start: every rate zero."""
    from pygsti_tpu_torch.models.cloudnoisemodel import \
        create_cloud_crosstalk_model_from_hops_and_weights
    return create_cloud_crosstalk_model_from_hops_and_weights(
        _spec(cfg), maxhops=cfg['maxhops'], max_idle_weight=cfg['max_idle_weight'],
        extra_gate_weight=cfg['extra_gate_weight'], gate_type=cfg['parameterization'],
        spam_type=cfg['spam_type'], max_spam_weight=cfg['max_spam_weight'],
        connected_highweight_errors=cfg['connected_highweight_errors'])


def design_circuits(cfg, device):
    """pyGSTi's cloud-noise design search (create_cloudnoise_circuits)."""
    from pygsti_tpu_torch.circuits.cloudcircuitconstruction import create_cloudnoise_circuits
    struct = create_cloudnoise_circuits(
        _spec(cfg), cfg['max_lengths'], [tuple(f) for f in cfg['fiducials']],
        max_idle_weight=cfg['max_idle_weight'], maxhops=cfg['maxhops'],
        extra_gate_weight=cfg['extra_gate_weight'], seed=cfg['design_seed'], device=device)
    circuits = list(struct)
    return circuits, [len(circuits)]
