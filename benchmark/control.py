"""The control of `correct`: a run of the cell through the harness, at the
cell's own size, with one guarantee of the configuration broken where the
program's answer is produced.  The program's `_seed_resolved` is wrapped
so that its stream keeps only the first `occ_cap` occurrences of each
emitted seed (the configuration's `control`), as a fixed occurrence list
would; the configuration states every occurrence up to `occ_thr`.  The
harness's own comparison has to make its result `correct: false`.

    python3 -m benchmark.control --workload <name> --seeds 1,2,3 [--seconds 3]

runs one such run a seed, one after another in this process, and prints
each run's result line (its `compared` readings beside their limit).  The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

# the stream packing's fill of an unused meta slot (kart_tpu's _pack_stream)
META_FILL_16, META_FILL_32 = -257, -1  # 0xFEFF as int16


def cut_stream(stream: torch.Tensor, B: int, H: int, pack16: bool, cap: int) -> torch.Tensor:
    """A packed resolved stream (B reads, H occurrence slots) with each
    seed's run of occurrences (consecutive entries of one read with the
    same rpos and length) cut to its first `cap`, packed again alike."""
    if isinstance(stream, tuple):
        raise ValueError("the control cuts an int32 index's packed stream only")
    dev = stream.device
    if pack16:
        cnts = stream[: B // 2].view(torch.int16).long()
        meta = stream[B // 2 : B // 2 + H // 2].view(torch.int16)
        gpos = stream[B // 2 + H // 2 :]
    else:
        cnts, meta, gpos = stream[:B].long(), stream[B : B + H], stream[B + H :]
    ok = cnts >= 0
    tot = torch.where(ok, cnts, -cnts - 1)
    read = torch.repeat_interleave(torch.arange(B, device=dev), tot)
    n = read.numel()
    m = meta[:n]
    start = torch.ones(n, dtype=torch.bool, device=dev)
    start[1:] = (read[1:] != read[:-1]) | (m[1:] != m[:-1])
    j = torch.arange(n, device=dev)
    keep = j - torch.cummax(torch.where(start, j, 0), 0).values < cap
    new_tot = torch.zeros(B, dtype=torch.long, device=dev).index_add_(0, read, keep.long())
    k = int(keep.sum())
    new_meta = torch.full_like(meta, META_FILL_16 if pack16 else META_FILL_32)
    new_meta[:k] = m[keep]
    new_gpos = torch.zeros_like(gpos)
    new_gpos[:k] = gpos[:n][keep]
    new_cnts = torch.where(ok, new_tot, -new_tot - 1)
    if pack16:
        return torch.cat([new_cnts.to(torch.int16).view(torch.int32),
                          new_meta.view(torch.int32), new_gpos])
    return torch.cat([new_cnts.to(torch.int32), new_meta, new_gpos])


def capped(seed_resolved, cap: int):
    """`_seed_resolved` with its stream cut by cut_stream."""

    def f(self, words, amb_r, amb_p, rlens, l_max, B):
        out = seed_resolved(self, words, amb_r, amb_p, rlens, l_max, B)
        return cut_stream(out, B, self._occ_budget(B, l_max), self._pack16(l_max), cap)

    return f


def control_runs(workload: str, seeds, seconds: float, device: str, root: str, log) -> list:
    """One harness run of the control a seed -> the result lines."""
    from kart_tpu_torch.pipeline.mapper import TorchKartMapper

    from benchmark import harness

    bench, cell, config, traffic = harness.load_cell(root, workload)
    orig = TorchKartMapper._seed_resolved
    TorchKartMapper._seed_resolved = capped(orig, int(config["control"]["occ_cap"]))
    out = []
    try:
        for seed in seeds:
            r = harness.run_loaded(bench, cell, config, traffic, seed=int(seed), seconds=seconds,
                                   trace=False, device=device, t_start=time.time(), root=root,
                                   log=log)
            out.append(dict(workload=workload, seed=int(seed), **r))
    finally:
        TorchKartMapper._seed_resolved = orig
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    runs = control_runs(args.workload, seeds, args.seconds, args.device, os.getcwd(),
                        lambda s: print(s, file=sys.stderr))
    for r in runs:
        print(json.dumps(r), flush=True)
    return 0 if all(r["correct"] is False for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
