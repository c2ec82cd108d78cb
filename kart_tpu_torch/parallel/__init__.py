"""Parallelism of the port: device meshes, the block-sharded FM index,
multi-host data parallelism and the ordered SAM merge.

Counterpart of kart_tpu/parallel/ (the same names): the multi-device
mapping steps (dp.py: make_data_mesh, an (n_data, n_idx) grid of torch
devices; make_mapping_step, the seeding step, and make_full_mapping_step,
the front half through the PosDiff sort, clustering and mating, reads
data-parallel over the grid's rows and the index replicated or split over
each row), the sharded index (sharded_index.py, -idx-shards: the index split
into slabs on N devices, each lookup summed over them), the multi-host host
layer (distributed.py: the torch.distributed group on gloo and the input
sharding; stats_sync.py: the exact cross-host insert-size relay and
map_shard) and merge.py.
"""

from .dp import make_data_mesh, make_full_mapping_step, make_mapping_step
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
    "make_data_mesh",
    "make_full_mapping_step",
    "make_mapping_step",
    "merge_sam_shards",
    "paired_record_ranges",
    "shard_libraries",
    "sharded_occ4_batch",
    "sharded_sa_gather",
    "sharded_seed_scan",
]
