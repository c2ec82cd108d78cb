"""Parallelism of the port: the block-sharded FM index, multi-host data
parallelism and the ordered SAM merge.

Counterpart of kart_tpu/parallel/ (the same names): the sharded index
(sharded_index.py, -idx-shards: the index split into slabs on N devices,
each lookup summed over them), the multi-host host layer (distributed.py:
the torch.distributed group on gloo and the input sharding; stats_sync.py:
the exact cross-host insert-size relay and map_shard) and merge.py.
kart_tpu's make_data_mesh and make_mapping_step are not ported.
"""

from .distributed import (
    fastq_record_offsets,
    init_distributed,
    paired_record_ranges,
    shard_libraries,
)
from .merge import OrderedChunkWriter, merge_sam_shards
from .sharded_index import (
    ShardedFM,
    build_sharded_fm,
    sharded_occ4_batch,
    sharded_sa_gather,
    sharded_seed_scan,
)

__all__ = [
    "OrderedChunkWriter",
    "ShardedFM",
    "build_sharded_fm",
    "fastq_record_offsets",
    "init_distributed",
    "merge_sam_shards",
    "paired_record_ranges",
    "shard_libraries",
    "sharded_occ4_batch",
    "sharded_sa_gather",
    "sharded_seed_scan",
]
