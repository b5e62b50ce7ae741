"""Counterpart of pygsti_tpu/modelpacks."""
