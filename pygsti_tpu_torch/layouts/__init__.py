"""Counterpart of pygsti_tpu/layouts."""
