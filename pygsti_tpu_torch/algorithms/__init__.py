"""Counterpart of pygsti_tpu/algorithms."""
