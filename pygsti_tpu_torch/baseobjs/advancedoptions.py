"""Validated advanced-options dicts for the legacy drivers (counterpart of
pygsti_tpu/baseobjs/advancedoptions.py)."""

from __future__ import annotations


class AdvancedOptions(dict):
    """A dict that validates its keys against a known set (reference:
    advancedoptions.AdvancedOptions)."""

    valid_keys = ()

    def __init__(self, items=None):
        super().__init__()
        if items:
            self.update(items)

    def __setitem__(self, key, val):
        if self.valid_keys and key not in self.valid_keys:
            raise ValueError(
                "Invalid advanced option '%s'.  Valid options: %s"
                % (key, ', '.join(sorted(self.valid_keys))))
        super().__setitem__(key, val)

    def update(self, d):
        for k, v in dict(d).items():
            self[k] = v


class GSTAdvancedOptions(AdvancedOptions):
    """Advanced options for the GST drivers (reference:
    advancedoptions.GSTAdvancedOptions)."""

    valid_keys = (
        'objective', 'tolerance', 'max_iterations', 'finite_diff_iterations',
        'starting_point', 'contract_start_to_cptp', 'depolarize_start',
        'randomize_start', 'cptp_penalty_factor', 'spam_penalty_factor',
        'profile', 'record_output', 'distribute_method', 'always_perform_mle',
        'only_perform_mle', 'estimate_label', 'appended_circuits',
        'prepended_circuits', 'germ_length_limits', 'include_lgst',
        'nested_circuit_lists', 'op_label_aliases', 'circuit_weights',
        'unreliable_ops', 'bad_fit_threshold', 'on_bad_fit', 'set trivial_gauge_group',
    )
