"""Multi-host data parallelism.

The reference is strictly single-host (pthreads + shared memory,
SURVEY.md §2d).  Scaling beyond one host is data parallelism over reads:
every host runs the same program, joins the torch.distributed process
group (gloo: it carries only small host tensors, never a read or the
index), maps a deterministic slice of the input libraries, and writes a
shard file; parallel.merge.merge_sam_shards restores single-host output.
Counterpart of kart_tpu/parallel/distributed.py; only init_distributed
differs (torch's MASTER_ADDR and MASTER_PORT where kart_tpu reads
JAX_COORDINATOR_ADDRESS).

Input sharding is deterministic and non-overlapping:
  * whole-file granularity when there are >= num_processes libraries
    (shard_libraries), else
  * byte-range granularity inside one FASTQ/FASTA (fastq_byte_ranges):
    ranges are aligned to record starts so each read belongs to exactly
    one shard; paired files are split by the SAME record indices so mates
    stay together.
"""

from __future__ import annotations

import os


def init_distributed(coordinator_address=None, num_processes=None, process_id=None):
    """Join the torch.distributed process group on gloo.  No-op when there
    is no coordinator: neither `coordinator_address` ("host:port") nor
    MASTER_ADDR in the environment (then MASTER_PORT, WORLD_SIZE and RANK
    as torch reads them, where num_processes and process_id are not given).
    Returns (process_index, process_count): (0, 1) when no group exists."""
    import torch.distributed as dist

    if not dist.is_initialized():
        if coordinator_address:
            init = f"tcp://{coordinator_address}"
        elif os.environ.get("MASTER_ADDR"):
            init = "env://"
        else:
            return 0, 1
        dist.init_process_group(
            "gloo", init_method=init,
            world_size=-1 if num_processes is None else num_processes,
            rank=-1 if process_id is None else process_id,
        )
    return dist.get_rank(), dist.get_world_size()


def shard_libraries(files1, files2, process_index: int, process_count: int):
    """Round-robin whole libraries across hosts.  Returns (files1, files2)
    slices for this host (files2 may be empty)."""
    f1 = [f for i, f in enumerate(files1) if i % process_count == process_index]
    f2 = [f for i, f in enumerate(files2) if i % process_count == process_index]
    return f1, f2


def _is_record_start(lines: list[bytes], i: int, fastq: bool) -> bool:
    if fastq:
        # a FASTQ record start is an @ line whose +2 line is the + separator
        # (an @ can also begin a quality line, so check structure)
        return (
            lines[i].startswith(b"@")
            and i + 2 < len(lines)
            and lines[i + 2].startswith(b"+")
        )
    return lines[i].startswith(b">")


def count_records(path: str, fastq: bool) -> int:
    n = 0
    with open(path, "rb") as f:
        if fastq:
            for i, _ in enumerate(f):
                n = i + 1
            return n // 4
        for line in f:
            n += line.startswith(b">")
    return n


def fastq_record_offsets(path: str, n_shards: int, fastq: bool = True):
    """Split one uncompressed FASTA/FASTQ into n_shards contiguous
    byte-ranges aligned to record starts.  Returns a list of (start, end)
    byte offsets, one per shard (some may be empty).  FASTQ alignment uses
    the @/+ two-line structure so quality lines starting with '@' cannot
    be mistaken for headers."""
    size = os.path.getsize(path)
    bounds = [0]
    with open(path, "rb") as f:
        for s in range(1, n_shards):
            target = size * s // n_shards
            f.seek(target)
            f.readline()  # finish partial line
            # read a small window of lines and find the first record start
            pos = f.tell()
            window = []
            offs = []
            for _ in range(12):
                offs.append(pos)
                line = f.readline()
                if not line:
                    break
                window.append(line)
                pos = f.tell()
            found = None
            for i in range(len(window)):
                if _is_record_start(window, i, fastq):
                    found = offs[i]
                    break
            bounds.append(size if found is None else found)
    bounds.append(size)
    # monotonicity (tiny files can fold shards together)
    for i in range(1, len(bounds)):
        bounds[i] = max(bounds[i], bounds[i - 1])
    return [(bounds[i], bounds[i + 1]) for i in range(n_shards)]


def paired_record_ranges(path1: str, path2: str, n_shards: int, fastq: bool = True):
    """Record-index ranges [(lo, hi)) per shard for a paired library: both
    files are split at the SAME record indices (mates stay together)."""
    n = count_records(path1, fastq)
    return [(n * s // n_shards, n * (s + 1) // n_shards) for s in range(n_shards)]
