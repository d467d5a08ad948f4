"""Host utilities (the counterpart of cc_tpu/utils)."""
