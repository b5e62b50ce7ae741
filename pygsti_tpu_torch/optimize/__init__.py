"""Counterpart of pygsti_tpu/optimize."""
