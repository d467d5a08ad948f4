"""Command-line entry points (python -m cc_tpu_torch.cli.<name>)."""
