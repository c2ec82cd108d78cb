"""Random-gather microbenchmark on one CUDA card: the formulations of
kart_tpu's `tools/bench_gather.py` as PyTorch ops, and its Pallas row-DMA
kernel as the hand-written `csrc/row_gather.cu`.

The funnel's floor is the per-round suffix-array hit gather: H random int32
loads from the 37 MB `sa_full` of an E. coli-scale genome, with indices
that come in runs (a 13-mer interval is a run of SA rows).  Formulations:

  flat              x[idx]                   H random elements
  sorted_flat       x[sort(idx)]             locality-sorted indices
  row_R             x2d[rid]                 distinct R-element rows
  two_level_R       rows = x2d[rid]; rows[pos, off]
  selreduce_4096    select-reduce from a 4096-entry table
  onehot_mxu_4096   one-hot matrix product from a 4096-entry table
  small_512KB       x[idx] from a 512 KB table
  row_128           x2d[rid] with 128-word rows (the kernel's plain version)
  pallas_dma_row128x8   csrc/row_gather.cu: 128-word rows, 8 per warp in
                    flight (the Pallas kernel's 8 DMAs in flight); checked
                    byte for byte against table[rid]

Each formulation runs on NV = 8 index variants; its time is the mean over
the variants of CUDA-event times after a warm-up pass.  One JSON line per
formulation, with kart_tpu's fields.

    python -m kart_tpu_torch.tools.bench_gather [--h 16384] [--n 9279361] [--runs 4096]

Without a CUDA device it exits non-zero and measures nothing.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

NV = 8  # index-set variants
PASSES = 4  # timed passes over the variants


def time_mean(fn) -> float:
    """Mean seconds of fn(k) over the NV variants: one warm-up pass, then
    PASSES passes between two CUDA events."""
    for k in range(NV):
        fn(k)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(PASSES):
        for k in range(NV):
            fn(k)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / (PASSES * NV)


def row_ids(idx_v, R):
    """Distinct row ids of each variant, padded to one power of two above
    the largest count (as kart_tpu's probe pads them), with each index's
    position in its list and its offset in the row."""
    rid_v, pos_v, off_v = [], [], []
    HR = 0
    for v in idx_v:
        rid = np.unique(v // R).astype(np.int32)
        rid_v.append(rid)
        pos_v.append(np.searchsorted(rid, v // R).astype(np.int32))
        off_v.append((v % R).astype(np.int32))
        HR = max(HR, len(rid))
    HR = 1 << int(np.ceil(np.log2(HR + 1)))
    return np.stack([np.pad(r, (0, HR - len(r))) for r in rid_v]), np.stack(pos_v), np.stack(off_v), HR


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--h", type=int, default=16384, help="hit count per round")
    ap.add_argument("--n", type=int, default=9_279_361, help="table entries")
    ap.add_argument("--runs", type=int, default=4096, help="distinct runs (lanes)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_gather: no CUDA device is available")
    from .. import kernels

    dev = torch.device("cuda")
    H, N = args.h, args.n
    rng = np.random.default_rng(0)
    table_np = rng.integers(0, N, size=N, dtype=np.int32)
    table = torch.from_numpy(table_np).to(dev)

    # NV variants of run-structured indices (runs of H/runs at random starts)
    idx_v = []
    for _ in range(NV):
        starts = np.sort(rng.integers(0, N - 64, size=args.runs))
        lens = np.full(args.runs, H // args.runs, np.int32)
        lens[: H % args.runs] += 1
        idx = np.concatenate([s + np.arange(ln) for s, ln in zip(starts, lens)])[:H]
        idx_v.append(idx.astype(np.int32))

    results = []

    def report(name, t, count, bytes_useful):
        results.append({
            "formulation": name,
            "ns_per_elem": round(1e9 * t / H, 2),
            "us_total": round(1e6 * t, 1),
            "gather_latencies": int(count),
            "ns_per_latency": round(1e9 * t / max(count, 1), 1),
            "useful_GBps": round(bytes_useful / max(t, 1e-12) / 1e9, 2),
        })
        print(json.dumps(results[-1]), flush=True)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev).long()

    idx_all = put(np.stack(idx_v))
    report("flat", time_mean(lambda k: table[idx_all[k]]), H, 4 * H)
    sidx_all = put(np.stack([np.sort(v) for v in idx_v]))
    report("sorted_flat", time_mean(lambda k: table[sidx_all[k]]), H, 4 * H)

    for R in (8, 16, 32):
        NR = N // R
        t2 = table[: NR * R].reshape(NR, R)
        rid, pos, off, HR = row_ids(idx_v, R)
        rid_all, pos_all, off_all = put(rid), put(pos), put(off)
        report(f"row_{R}", time_mean(lambda k: t2[rid_all[k]]), HR, 4 * H)

        def two(k, t2=t2, rid_all=rid_all, pos_all=pos_all, off_all=off_all):
            return t2[rid_all[k]][pos_all[k], off_all[k]]

        report(f"two_level_{R}", time_mean(two), HR, 4 * H)

    NTB = 4096
    tbl_small = torch.from_numpy(rng.integers(0, 2**20, size=NTB, dtype=np.int32)).to(dev)
    si_all = put(np.stack([rng.integers(0, NTB, size=H).astype(np.int32) for _ in range(NV)]))
    ar_tb = torch.arange(NTB, device=dev)

    def selred(k):
        return torch.where(si_all[k][:, None] == ar_tb[None, :], tbl_small[None, :], 0).sum(1)

    report(f"selreduce_{NTB}", time_mean(selred), H, 4 * H)
    tbl_f = tbl_small.float()

    def onehot(k):
        return ((si_all[k][:, None] == ar_tb[None, :]).float() @ tbl_f).int()

    report(f"onehot_mxu_{NTB}", time_mean(onehot), H, 4 * H)

    small = torch.from_numpy(rng.integers(0, 2**31 - 1, size=131072, dtype=np.int32)).to(dev)
    sm_all = put(np.stack([rng.integers(0, 131072, size=H).astype(np.int32) for _ in range(NV)]))
    report("small_512KB", time_mean(lambda k: small[sm_all[k]]), H, 4 * H)

    # the Pallas row-DMA probe: 128-word rows by the hand-written kernel
    R = 128
    NR = N // R
    t2p = table[: NR * R].reshape(NR, R)
    ridp, _, _, HRp = row_ids(idx_v, R)
    ridp_all = torch.from_numpy(ridp).to(dev)
    ridp_long = ridp_all.long()
    report(f"row_{R}", time_mean(lambda k: t2p[ridp_long[k]]), HRp, 4 * H)
    for k in range(NV):
        if not torch.equal(kernels.row_gather(t2p, ridp_all[k]), t2p[ridp_all[k].long()]):
            raise AssertionError(f"row_gather differs from table[rid] on variant {k}")
    report(f"pallas_dma_row{R}x8", time_mean(lambda k: kernels.row_gather(t2p, ridp_all[k])),
           HRp, 4 * H)
    return results


if __name__ == "__main__":
    main()
