"""Host-side data pipeline: datasets, joint transforms, threaded loading,
and the prefetch of batches to the GPU. NHWC numpy on the host (the
counterpart of cc_tpu/data, with the same exports)."""
from cc_tpu_torch.data.sequence_folders import SequenceFolder
from cc_tpu_torch.data.validation import ValidationSet
from cc_tpu_torch.data.loader import DataLoader, device_prefetch
from cc_tpu_torch.data import transforms

__all__ = ["SequenceFolder", "ValidationSet", "DataLoader",
           "device_prefetch", "transforms"]
