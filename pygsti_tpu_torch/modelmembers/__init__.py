"""Counterpart of pygsti_tpu/modelmembers."""
