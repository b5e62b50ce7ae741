"""Counterpart of pygsti_tpu/data."""
