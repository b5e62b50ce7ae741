"""Counterpart of pygsti_tpu/circuits."""
