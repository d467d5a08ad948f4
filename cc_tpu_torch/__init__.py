"""PyTorch/CUDA port of cc_tpu (Competitive Collaboration) for NVIDIA Hopper.

The nets run NCHW internally so that convolutions go through cuDNN; the
public functions keep cc_tpu's NHWC layout and batch dict. The local
correlation is a hand-written CUDA kernel (ops/csrc/correlation.cu) with a
plain PyTorch version beside it, which runs for tensors on the CPU.

Entry points run on the GPU unless the caller passes device="cpu".
"""
from cc_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
