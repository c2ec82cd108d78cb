"""Mesh sizes of the port's data-parallel seeding step
(parallel/dp.py::make_mapping_step).

Counterpart of the repository's root tools/bench_scaling.py (kart_tpu's,
which measures its jitted step on 8 virtual CPU devices).  It times the step
at 1, 2, 4 and 8 data blocks on a fixed batch of 2,048 reads of 128 bases
(graft_entry's tiny index), and the sharded-index mode at data x idx = 4 x
2, and prints one JSON line per configuration, then each one's reads/s
over 1 block's times its block count.

Every mesh position sits on one device: cuda:0, or the CPU with --cpu.
So the "efficiency" is what each extra position costs (a smaller block a
launch, the sharded index's per-step sums), not scaling: one card cannot
measure scaling across cards.  The first line, before the JSON, names the
device and how many positions share it.  Without --cpu and without a CUDA
device it exits non-zero and measures nothing.

    python -m kart_tpu_torch.tools.bench_scaling [--cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..graft_entry import _example_reads, _tiny_index
from ..parallel import make_data_mesh, make_mapping_step
from .profile_device import device_for

CONFIGS = ((1, 1), (2, 1), (4, 1), (8, 1), (4, 2))
BATCH = 2048


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_line(dev: torch.device, positions: int) -> str:
    """The line before the JSON: the device, and that every mesh position
    shares it."""
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return (f"# device {dev} ({name}): every position of each mesh, up to {positions}, shares"
            f" it; the efficiency below is per-position overhead, not scaling")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="put every mesh position on the CPU")
    args = ap.parse_args(argv)
    dev = device_for(args.cpu)
    gidx = _tiny_index()
    rlen, min_seed = 128, 13
    max_seeds = rlen // (min_seed + 1) + 1
    B = BATCH
    reads, rlens = _example_reads(gidx, B, rlen, seed=3)
    print(device_line(dev, max(d * i for d, i in CONFIGS)), flush=True)
    results = []
    for n_data, n_idx in CONFIGS:
        mesh = make_data_mesh(n_data, n_idx, devices=[dev] * (n_data * n_idx))
        step, place = make_mapping_step(
            mesh, gidx, idx_axis="idx" if n_idx > 1 else None,
            min_seed_len=min_seed, max_seeds=max_seeds, l_max=rlen,
        )
        r, rl = place(reads, rlens)
        step(r, rl)  # warm: kernels built and loaded
        sync(dev)
        rates = []
        for _ in range(3):
            t0 = time.perf_counter()
            step(r, rl)
            sync(dev)
            rates.append(B / (time.perf_counter() - t0))
        rec = dict(
            config=f"data={n_data}" + (f",idx={n_idx}" if n_idx > 1 else ""),
            reads_per_sec=round(max(rates), 1),
        )
        results.append(rec)
        print(json.dumps(rec), flush=True)
    base = results[0]["reads_per_sec"]
    for rec in results[1:]:
        n = int(rec["config"].split("=")[1].split(",")[0])
        eff = rec["reads_per_sec"] / (base * n)
        print(json.dumps({"config": rec["config"],
                          "scaling_efficiency_vs_1": round(eff, 3)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
