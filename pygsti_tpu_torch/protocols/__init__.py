"""Counterpart of pygsti_tpu/protocols."""
