"""Counterpart of pygsti_tpu/objectivefns."""
