"""Evaluation: the composite rigid and non-rigid flow (the counterpart of
cc_tpu/eval)."""
