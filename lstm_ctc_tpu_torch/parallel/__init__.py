"""Data parallelism over a ``torch.distributed`` process group
(``parallel/mesh.py``; counterpart of ``lstm_ctc_tpu/parallel``)."""

from .mesh import (SEED_STRIDE, SHARD_KEY, Shard, barrier, batch_moments,
                   combine, gather_rows, join, launched, leave, local_device,
                   rank, shard_batch, split_rows, world_size)
