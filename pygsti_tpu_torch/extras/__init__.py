"""Optional extensions (counterpart of pygsti_tpu/extras/)."""
