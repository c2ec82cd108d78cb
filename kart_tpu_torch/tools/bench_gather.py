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
  pallas_dma_row128x8   csrc/row_gather.cu on the same rows (TMA bulk
                    copies through a shared-memory ring); checked byte for
                    byte against table[rid] on every variant

Each formulation runs on NV = 8 index variants and is timed as kart_tpu's
probe times it (`time_slope`): the slope between a CUDA graph of 8 calls and
one of 136, call i on variant i % NV, each replayed three times between two
CUDA events.  The graph is the counterpart of kart_tpu's jitted
`fori_loop`: launch and replay costs cancel in the slope, which is device
time per call.  (Eager PyTorch drops no work, so no checksum is needed.)  A
formulation that cannot be captured raises.  One JSON line per formulation,
with kart_tpu's fields.  The row ids of each variant are padded to a power
of two above the largest distinct count, as in kart_tpu: 8,192 rows of 128
words at the defaults, 65,536 at the second size below.

    python -m kart_tpu_torch.tools.bench_gather [--h 16384] [--n 9279361] [--runs 4096]
    python -m kart_tpu_torch.tools.bench_gather --h 262144 --runs 65536 --row128

`--row128` runs only the row-128 pair (the other formulations build
(H, 4096) intermediates, gigabytes at H = 262,144).  Without a CUDA device
it exits non-zero and measures nothing.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

NV = 8  # index-set variants
PASSES = 4  # passes over the variants of a per-call timing
N_TABLE = 9_279_361  # sa_full entries of the E. coli-scale genome


def time_slope(run, n_small: int = 8, n_big: int = 136) -> float:
    """Seconds per call by slope, as kart_tpu's `time_slope`: run(n) gives
    the seconds of n calls on the device; each size is run three times and
    the fixed costs cancel in max(min(big) - min(small), 0) / (n_big -
    n_small)."""
    ts, tb = [], []
    for _ in range(3):
        ts.append(run(n_small))
        tb.append(run(n_big))
    return max(min(tb) - min(ts), 0.0) / (n_big - n_small)


def graph_run(name: str, fn):
    """run(n) for time_slope: seconds of one replay of a CUDA graph of n
    calls fn(i % NV), timed by two CUDA events.  Each variant runs once
    first, outside capture (kernel build, library load, launch attributes);
    a graph is captured at the first request of its size and replayed once
    untimed.  Each replay adds the row-gather launches it makes to
    `kernels.row_gather.launches` (the wrapper counts none while a graph
    is captured).  Raises, naming the formulation, if it cannot be
    captured."""
    from .. import kernels

    counted = kernels.row_gather.launches
    for k in range(NV):
        fn(k)
    per_call = (kernels.row_gather.launches - counted) // NV  # row-gather launches of one call
    torch.cuda.synchronize()
    graphs = {}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def run(n: int) -> float:
        g = graphs.get(n)
        if g is None:
            g = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(g):
                    for i in range(n):
                        fn(i % NV)
            except Exception as e:
                raise RuntimeError(f"{name}: cannot be captured in a CUDA graph ({e})") from e
            g.replay()
            kernels.row_gather.launches += n * per_call
            torch.cuda.synchronize()
            graphs[n] = g
        start.record()
        g.replay()
        end.record()
        kernels.row_gather.launches += n * per_call
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    return run


def time_mean(fn) -> float:
    """Per-call seconds of fn(k) over the NV variants by one event window
    around PASSES passes of eager calls, after a warm-up pass: host
    dispatch shows in it wherever a call enqueues slower than it runs."""
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


def make_variants(h: int, n: int, runs: int):
    """kart_tpu's probe inputs from seed 0: the (n,) int32 table and NV
    variants of h run-structured indices (runs of h/runs at random
    starts).  Returns the generator too, for the formulations that draw
    more from it."""
    rng = np.random.default_rng(0)
    table = rng.integers(0, n, size=n, dtype=np.int32)
    idx_v = []
    for _ in range(NV):
        starts = np.sort(rng.integers(0, n - 64, size=runs))
        lens = np.full(runs, h // runs, np.int32)
        lens[: h % runs] += 1
        idx = np.concatenate([s + np.arange(ln) for s, ln in zip(starts, lens)])[:h]
        idx_v.append(idx.astype(np.int32))
    return rng, table, idx_v


def row_ids(idx_v, R):
    """Distinct row ids of each variant, padded with row 0 to one power of
    two above the largest count (as kart_tpu's probe pads them), with each
    index's position in its list and its offset in the row."""
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


def probe(h: int = 16384, n: int = N_TABLE, runs: int = 4096, *, row128_only: bool = False):
    """Every formulation (or only the row-128 pair) at one size, one JSON
    line each.  Returns the records and, for the row-128 pair,
    {formulation: (seconds by slope, seconds per call by `time_mean`)}."""
    if not torch.cuda.is_available():
        raise SystemExit("bench_gather: no CUDA device is available")
    from .. import kernels

    dev = torch.device("cuda")
    H = h
    rng, table_np, idx_v = make_variants(h, n, runs)
    table = torch.from_numpy(table_np).to(dev)
    results = []

    def report(name, fn, count, bytes_useful):
        t = time_slope(graph_run(name, fn))
        results.append({
            "formulation": name,
            "ns_per_elem": round(1e9 * t / H, 2),
            "us_total": round(1e6 * t, 1),
            "gather_latencies": int(count),
            "ns_per_latency": round(1e9 * t / max(count, 1), 1),
            "useful_GBps": round(bytes_useful / max(t, 1e-12) / 1e9, 2),
        })
        print(json.dumps(results[-1]), flush=True)
        return t

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev).long()

    if not row128_only:
        idx_all = put(np.stack(idx_v))
        report("flat", lambda k: table[idx_all[k]], H, 4 * H)
        sidx_all = put(np.stack([np.sort(v) for v in idx_v]))
        report("sorted_flat", lambda k: table[sidx_all[k]], H, 4 * H)

        for R in (8, 16, 32):
            NR = n // R
            t2 = table[: NR * R].reshape(NR, R)
            rid, pos, off, HR = row_ids(idx_v, R)
            rid_all, pos_all, off_all = put(rid), put(pos), put(off)
            report(f"row_{R}", lambda k, t2=t2, rid_all=rid_all: t2[rid_all[k]], HR, 4 * H)

            def two(k, t2=t2, rid_all=rid_all, pos_all=pos_all, off_all=off_all):
                return t2[rid_all[k]][pos_all[k], off_all[k]]

            report(f"two_level_{R}", two, HR, 4 * H)

        NTB = 4096
        tbl_small = torch.from_numpy(rng.integers(0, 2**20, size=NTB, dtype=np.int32)).to(dev)
        si_all = put(np.stack([rng.integers(0, NTB, size=H).astype(np.int32) for _ in range(NV)]))
        ar_tb = torch.arange(NTB, device=dev)

        def selred(k):
            return torch.where(si_all[k][:, None] == ar_tb[None, :], tbl_small[None, :], 0).sum(1)

        report(f"selreduce_{NTB}", selred, H, 4 * H)
        tbl_f = tbl_small.float()

        def onehot(k):
            return ((si_all[k][:, None] == ar_tb[None, :]).float() @ tbl_f).int()

        report(f"onehot_mxu_{NTB}", onehot, H, 4 * H)

        small = torch.from_numpy(rng.integers(0, 2**31 - 1, size=131072, dtype=np.int32)).to(dev)
        sm_all = put(np.stack([rng.integers(0, 131072, size=H).astype(np.int32) for _ in range(NV)]))
        report("small_512KB", lambda k: small[sm_all[k]], H, 4 * H)

    # the Pallas row-DMA probe: 128-word rows by the hand-written kernel
    NR = n // 128
    t2p = table[: NR * 128].reshape(NR, 128)
    ridp, _, _, HRp = row_ids(idx_v, 128)
    ridp_all = torch.from_numpy(ridp).to(dev)
    ridp_long = ridp_all.long()
    for k in range(NV):
        if not torch.equal(kernels.row_gather(t2p, ridp_all[k]), t2p[ridp_long[k]]):
            raise AssertionError(f"row_gather differs from table[rid] on variant {k} ({HRp} rows)")
    pair = {"row_128": lambda k: t2p[ridp_long[k]],
            "pallas_dma_row128x8": lambda k: kernels.row_gather(t2p, ridp_all[k])}
    slope = {name: report(name, fn, HRp, 4 * H) for name, fn in pair.items()}
    return results, {name: (slope[name], time_mean(fn)) for name, fn in pair.items()}


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--h", type=int, default=16384, help="hit count per round")
    ap.add_argument("--n", type=int, default=N_TABLE, help="table entries")
    ap.add_argument("--runs", type=int, default=4096, help="distinct runs (lanes)")
    ap.add_argument("--row128", action="store_true", help="only the row-128 pair")
    args = ap.parse_args(argv)
    return probe(args.h, args.n, args.runs, row128_only=args.row128)[0]


if __name__ == "__main__":
    main()
