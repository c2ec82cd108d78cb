"""Worker process of the two-process torch.distributed run
(test_torch_multihost.py::test_two_process_torch_distributed on the CPU,
chip_smoke.py's phase 11 (c) on the card).

Each worker joins the gloo process group through the port's
init_distributed, proves the group with an all_gather of its rank, maps its
input shard with exact sequential stat semantics through the TCP stat relay
(kart_tpu_torch.parallel.stats_sync), and writes a SAM shard.  The config
may name the mapper's `device` (default cpu) and its `idx_shards` (default
1; every shard on that device).  It imports the port only, never jax or
kart_tpu."""

import json
import sys


def main():
    cfg = json.load(open(sys.argv[1]))
    sys.path.insert(0, cfg["repo"])
    import torch
    import torch.distributed as dist

    from kart_tpu_torch.index import load_index
    from kart_tpu_torch.parallel import init_distributed
    from kart_tpu_torch.parallel.stats_sync import SocketStatRelay, map_shard
    from kart_tpu_torch.pipeline.mapper import TorchKartMapper

    rank, size = init_distributed(cfg["coordinator"], cfg["nprocs"], cfg["pid"])
    assert (rank, size) == (cfg["pid"], cfg["nprocs"]), (rank, size)
    got = [torch.zeros(1, dtype=torch.int64) for _ in range(size)]
    dist.all_gather(got, torch.tensor([rank]))
    assert sorted(int(t) for t in got) == list(range(size)), got

    dev = torch.device(cfg.get("device", "cpu"))
    n_shards = cfg.get("idx_shards", 1)
    mapper = TorchKartMapper(load_index(cfg["prefix"]), device=dev, idx_shards=n_shards,
                             shard_devices=[dev] * n_shards)
    relay = SocketStatRelay(cfg["relay_host"], cfg["relay_port"])
    counters = {}
    with open(cfg["out"], "w") as f:
        map_shard(mapper, cfg["r1"], cfg["r2"], True, True, relay, cfg["first_chunk"], f.write,
                  counters)
    relay.close()
    dist.barrier()
    dist.destroy_process_group()
    loaded = [m for m, v in sys.modules.items() if v is not None
              and m.split(".")[0] in ("jax", "kart_tpu")]
    assert not loaded, loaded
    counters["groups"] = len(mapper.group_log)
    print(f"WORKER_OK pid={rank} {json.dumps(counters)}", flush=True)


if __name__ == "__main__":
    main()
