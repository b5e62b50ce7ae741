"""Counterpart of pygsti_tpu/forwardsims."""
