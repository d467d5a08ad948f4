"""Data parallelism over processes, one device each (torchrun): the
counterpart of cc_tpu/parallel. The launch and the collectives are in
`distributed`, the batch split in `mesh`."""
from cc_tpu_torch.parallel.mesh import batch_slice, shard_batch

__all__ = ["batch_slice", "shard_batch"]
