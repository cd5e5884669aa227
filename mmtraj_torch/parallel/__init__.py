"""Data parallelism over ``torch.distributed`` (counterpart of ``mmtraj/parallel``)."""

from mmtraj_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    all_gather_rows,
    all_reduce_sum,
    init_distributed,
    is_writer,
    make_mesh,
    shard_batch,
)
