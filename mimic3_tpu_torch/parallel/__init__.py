"""Data and tensor parallelism on torch devices and ``torch.distributed``
(port of ``mimic3_tpu/parallel``; ``tensor`` holds the tp collectives that
XLA inserts for the reference)."""

from .distributed import (  # noqa: F401
    all_gather_rows,
    all_reduce_sum,
    initialize_distributed,
    make_global_mesh,
    process_local_batch_slice,
)
from .mesh import (  # noqa: F401
    LocalRow,
    Mesh,
    batch_sharding,
    gather_params,
    make_mesh,
    param_sharding,
    shard_batch,
    shard_params,
)
from .tensor import Row, Split  # noqa: F401
