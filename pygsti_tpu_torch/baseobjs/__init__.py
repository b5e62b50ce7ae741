"""Counterpart of pygsti_tpu/baseobjs."""
