"""Counterpart of pygsti_tpu/tools."""
