"""Counterpart of pygsti_tpu/models."""
