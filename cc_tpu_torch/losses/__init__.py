"""The five CC losses and their helpers (counterpart of cc_tpu/losses/)."""
