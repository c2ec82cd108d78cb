"""Clock stamps and times of the sampled-SA walk's step on one CUDA card.

    python -m kart_tpu_torch.tools.stamp_walk                   # simdata's genome
    python -m kart_tpu_torch.tools.stamp_walk --genome-mbp 96   # an index past the L2
    python -m kart_tpu_torch.tools.stamp_walk --compare DIR     # DIR's walk in turns

The rows are the resolved stream of one device-pipelined group (32,000
reads of 150 bp cut from the genome, 1% substitutions, an N in 5% of them,
seeded by the FM stepper on the card): 96,000 SA rows.  Builds
csrc/stamp_walk.cu on its own (with this checkout's fm_index.cuh) and, for
each design of that file's step (`--designs`, int32) and for the header's
own walk (`sa_walk.cu`'s loop, flat and through a shard table of two
shards, int32 and int64), checks (pos, done) against sa_walk_plain and
prints a JSON line: the slope over CUDA graphs of the whole list and of the
longest row alone, ns a step (slope / (longest + 1)), and the clock64 split
of the longest row's steps (cycles from k to the addresses, load issue to
first use, first use to the next row, the loop's own) in its first 16 steps
in the whole launch, while most rows are in flight, and in its last 64, and
alone.  `--compare DIR` also times DIR's `kernels.sa_walk` in turns with
this checkout's (other, this, this, other), int32 and int64.  Without a
CUDA device it raises.

The index is simdata's E. coli-scale genome (seed 7) in `--data`, or with
`--genome-mbp N` a random genome of N million bases from `--seed`, built
with the port's builder (the build is timed).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import time

import numpy as np
import torch

from .. import kernels
from ..ops import fm_search as tfm
from ..parallel import sharded_index as tsi
from .bench_kernels import time_both

STAMP_SRC = os.path.join(os.path.dirname(kernels.SOURCES[0]), "stamp_walk.cu")
STAMP_LIB = os.path.join(kernels.BUILD_DIR, "libkartstamp.so")
MAX_STAMPED = 1024  # kMaxStamped of csrc/stamp_walk.cu
EARLY, TAIL = 16, 64  # steps of the split's two windows
GROUP_B, READ_LEN, L_MAX = 32000, 150, 160
_ACGT = np.frombuffer(b"ACGT", np.uint8)


def load_lib():
    kernels.build(STAMP_LIB, [STAMP_SRC])
    lib = ctypes.CDLL(STAMP_LIB)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.kart_stamp_design_walk.argtypes = [i, i, i, i, p, p, p, p, p, ll, p, i, i, i, p, p, p, p]
    lib.kart_stamp_design_walk.restype = i
    lib.kart_stamp_header_walk.argtypes = [i, i, p, i, ll, ll, p, p, p, p, ll, p, i, i, i, p, p,
                                           p, p]
    lib.kart_stamp_header_walk.restype = i
    return lib


def genome_index(data: str, genome_mbp: float | None, seed: int):
    """(loaded index, build seconds or None): simdata's genome, or a random
    genome of genome_mbp million bases, indexed by the port's builder where
    its files are missing."""
    from ..index import build_index, index_files_exist, load_index
    from . import simdata

    sub = data if genome_mbp is None else os.path.join(data, f"random_{genome_mbp:g}mbp_{seed}")
    os.makedirs(sub, exist_ok=True)
    fa, prefix = os.path.join(sub, "genome.fa"), os.path.join(sub, "idx")
    built = None
    if not (os.path.exists(fa) and index_files_exist(prefix) and os.path.exists(prefix + ".saf")):
        if genome_mbp is None:
            seq = simdata.make_repeat_genome(np.random.default_rng(simdata.GENOME_SEED))
        else:
            seq = _ACGT[np.random.default_rng(seed).integers(0, 4, int(genome_mbp * 1e6))]
        simdata.write_genome_fasta(fa, seq)
        t0 = time.perf_counter()
        build_index(fa, prefix, verbose=False)
        built = time.perf_counter() - t0
    return load_index(prefix), built


def stream_rows(seeds, max_seeds: int, H: int):
    """The SA row of every slot of the resolved stream of a packed FM-stepper
    array (row 1 past the last fitting read), as expand_resolve walks them."""
    from ..ops.resolve import expand_resolve_plain, seed_fields

    seen = []

    def lookup(rows):
        seen.append(rows)
        return rows, torch.ones_like(rows, dtype=torch.bool)

    o = seed_fields(seeds, max_seeds, False)
    expand_resolve_plain(lookup, o["n_seeds"], o["rpos"], o["slen"], o["k0"], o["freq"], o["ok"],
                         occ_budget=H)
    return seen[0].contiguous()


def group_stream_rows(gidx, fm, seed: int = 13):
    """The resolved stream's rows of one group of GROUP_B reads (3 * GROUP_B
    slots)."""
    from ..pipeline.mapper import compute_min_seed_length

    rng = np.random.default_rng(seed)
    codes = gidx.ref_codes
    starts = rng.integers(0, gidx.two_genome_size - READ_LEN, GROUP_B)
    reads = np.full((GROUP_B, L_MAX), 4, np.int32)
    reads[:, :READ_LEN] = codes[starts[:, None] + np.arange(READ_LEN)]
    sub = rng.random((GROUP_B, READ_LEN)) < 0.01
    reads[:, :READ_LEN][sub] = (reads[:, :READ_LEN][sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    ns = np.nonzero(rng.random(GROUP_B) < 0.05)[0]
    reads[ns, rng.integers(0, READ_LEN, len(ns))] = 4
    msl = compute_min_seed_length(gidx.two_genome_size)
    ms = L_MAX // (msl + 1) + 1
    dev = fm.L2.device
    seeds = kernels.fm_seed_scan(fm, torch.from_numpy(reads).to(dev),
                                 torch.full((GROUP_B,), READ_LEN, dtype=torch.int32, device=dev),
                                 msl, max_seeds=ms, l_max=L_MAX)
    return stream_rows(seeds, ms, 3 * GROUP_B)


def wide(fm):
    """The int64 twin of an FMIndexTensors (the BWT words shared)."""
    return tfm.FMIndexTensors(occ_cp=fm.occ_cp.long(), bwt_words=fm.bwt_words,
                              sa_samples=fm.sa_samples.long(), L2=fm.L2.long(),
                              primary=fm.primary, seq_len=fm.seq_len)


def records(fm, counts: bool = False) -> torch.Tensor:
    """(n_blocks * 16,) int32: a block's 64-byte record, its checkpoint row,
    its eight BWT words and, at int32, 16 bytes of padding, or with `counts`
    four words, the counts of each code (a byte each, code c at byte c) in
    the words before words 0, 2, 4 and 6."""
    nb = fm.bwt_words.numel() // 8
    cp = fm.occ_cp.view(nb, 4).view(torch.int32).view(nb, -1)
    words = fm.bwt_words.view(nb, 8)
    parts = [cp, words]
    if counts:
        w = words.long() & 0xFFFFFFFF
        codes = (w[:, :, None] >> (2 * torch.arange(16, device=w.device))) & 3  # (nb, 8, 16)
        per_word = torch.stack([(codes == c).sum(dim=2) for c in range(4)], dim=2)  # (nb, 8, 4)
        before = torch.cumsum(per_word, dim=1) - per_word  # counts before each word
        packed = (before[:, 0::2, :] << (8 * torch.arange(4, device=w.device))).sum(dim=2)
        parts.append(packed.to(torch.int32))
    elif cp.shape[1] == 4:
        parts.append(torch.zeros((nb, 4), dtype=torch.int32, device=cp.device))
    return torch.cat(parts, dim=1).reshape(-1).contiguous()


def split(st: np.ndarray, lo: int, hi: int) -> dict:
    """Median cycles of steps [lo, hi) of a (steps, 4) stamp array: k to the
    addresses, load issue to first use, first use to the next row, the
    loop's own (the next step's t0 less this one's t2), and the whole step."""
    s = st[lo:hi]
    nxt = st[lo + 1:hi + 1, 0] if hi < len(st) else st[lo + 1:, 0]
    loop = nxt - s[: len(nxt), 3]
    return dict(addr=float(np.median(s[:, 1] - s[:, 0])), load=float(np.median(s[:, 2] - s[:, 1])),
                after=float(np.median(s[:, 3] - s[:, 2])),
                loop=float(np.median(loop)) if len(loop) else None,
                step=float(np.median(np.diff(st[lo:hi + 1, 0]))) if hi - lo > 1 else None)


class Walker:
    """One walk formulation on one index: run(rows, target, stamp) ->
    (pos, done, stamps)."""

    def __init__(self, lib, fm, design=None, sfm=None, pin: bool = True):
        self.lib, self.fm, self.design, self.sfm, self.pin = lib, fm, design, sfm, pin
        self.i64 = int(fm.index_dtype == torch.int64)
        self.rec = records(fm, design == 5) if design in (3, 4, 5) else None
        self.l2host = np.ascontiguousarray(fm.L2.cpu().numpy()[:4].astype(np.int64))
        self.table = None if sfm is None else tsi.shard_table(sfm, sfm.shards)

    def run(self, rows, target: int = -1, stamp: bool = False, out=None):
        n = rows.numel()
        dev = rows.device
        pos, done, stamps = out or (torch.empty_like(rows), torch.empty(n, dtype=torch.uint8,
                                                                        device=dev),
                                    torch.zeros((MAX_STAMPED, 4), dtype=torch.int64, device=dev))
        fm = self.fm
        strm = torch.cuda.current_stream().cuda_stream
        if self.design is not None:
            rc = self.lib.kart_stamp_design_walk(
                self.design, int(self.pin), self.i64, int(stamp), fm.occ_cp.data_ptr(), fm.bwt_words.data_ptr(),
                None if self.rec is None else self.rec.data_ptr(), fm.sa_samples.data_ptr(),
                self.l2host.ctypes.data, fm.primary, rows.data_ptr(), n, tfm.SA_WALK_MAX_STEPS,
                target, stamps.data_ptr(), pos.data_ptr(), done.data_ptr(), strm)
        else:
            t = self.table
            rc = self.lib.kart_stamp_header_walk(
                self.i64, int(stamp), None if t is None else t.data_ptr(),
                0 if t is None else t.shape[0], 0 if t is None else self.sfm.nb_local,
                0 if t is None else self.sfm.nsamp_local, fm.occ_cp.data_ptr(),
                fm.bwt_words.data_ptr(), fm.sa_samples.data_ptr(), fm.L2.data_ptr(), fm.primary,
                rows.data_ptr(), n, tfm.SA_WALK_MAX_STEPS, target, stamps.data_ptr(),
                pos.data_ptr(), done.data_ptr(), strm)
        if rc != 0:
            raise RuntimeError(f"stamp_walk: CUDA launch failed with cudaError {rc}")
        return pos, done, stamps


def measure(name: str, w: Walker, rows, want, steps) -> dict:
    """The checks, slopes and stamp splits of one formulation."""
    pos, done, _ = w.run(rows)
    if not (torch.equal(pos, want[0]) and torch.equal(done.bool(), want[1])):
        raise AssertionError(f"stamp_walk {name}: (pos, done) differ from sa_walk_plain's")
    longest = int(steps.max())
    target = int(torch.argmax(steps))
    alone = rows[target:target + 1].clone()
    buf = (torch.empty_like(rows), torch.empty(rows.numel(), dtype=torch.uint8,
                                               device=rows.device),
           torch.zeros((MAX_STAMPED, 4), dtype=torch.int64, device=rows.device))
    buf1 = tuple(x[:1] if i < 2 else torch.zeros_like(x) for i, x in enumerate(buf))
    t_all = time_both(lambda: w.run(rows, out=buf))
    t_one = time_both(lambda: w.run(alone, out=buf1))
    n_st = min(longest, MAX_STAMPED)
    st_all = w.run(rows, target, True, out=buf)[2][:n_st].cpu().numpy()
    st_one = w.run(alone, 0, True, out=buf1)[2][:n_st].cpu().numpy()
    span = float(st_one[-1, 3] - st_one[0, 0])
    rec = dict(name=name, rows=rows.numel(), longest=longest, mean_steps=float(steps.float().mean()),
               slope_ms=1e3 * t_all[0], per_call_ms=1e3 * t_all[1], alone_slope_ms=1e3 * t_one[0],
               ns_a_step=1e6 * t_all[0] / (longest + 1),
               alone_ns_a_step=1e6 * t_one[0] / (longest + 1),
               clock_ghz=span / (1e9 * t_one[0]) if t_one[0] > 0 else None,
               split_early=split(st_all, 0, min(EARLY, n_st)),
               split_tail=split(st_all, max(0, n_st - TAIL), n_st),
               split_alone=split(st_one, 0, n_st))
    print(json.dumps(rec))
    return rec


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", default="chip_smoke_data")
    ap.add_argument("--genome-mbp", type=float, default=None)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--designs", default="0,1,2,3,4,5,6,7")
    ap.add_argument("--no-pin", action="store_true",
                    help="let the compiler place the designs' loads (fm_index.cuh's hold off)")
    ap.add_argument("--no-header", action="store_true", help="skip the header's own walk")
    ap.add_argument("--compare", metavar="DIR", default=None)
    ap.add_argument("--out", default=None, help="also write every record to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("stamp_walk: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"stamp_walk: {smi}")
    gidx, built = genome_index(args.data, args.genome_mbp, args.seed)
    fm32 = tfm.FMIndexTensors.from_genome_index(gidx, "cuda", with_full_sa=False)
    index_mb = (fm32.occ_cp.nbytes + fm32.bwt_words.nbytes + fm32.sa_samples.nbytes) / 1e6
    print(json.dumps(dict(genome_bp=int(gidx.genome_size), text_rows=int(gidx.seq_len),
                          index_mb_int32=index_mb, build_s=built)))
    lib = load_lib()
    rows32 = group_stream_rows(gidx, fm32)
    out = []
    for dt, fm in (("int32", fm32), ("int64", wide(fm32))):
        rows = rows32.to(fm.index_dtype)
        st: dict = {}
        want = tfm.sa_walk_plain(fm, rows, stats=st)
        steps = st["steps"]
        if dt == "int32":
            for d in (int(x) for x in args.designs.split(",") if x):
                out.append(measure(f"design {d}{' unpinned' if args.no_pin else ''} {dt}",
                                   Walker(lib, fm, design=d, pin=not args.no_pin), rows, want,
                                   steps))
        if not args.no_header:
            out.append(measure(f"header flat {dt}", Walker(lib, fm), rows, want, steps))
            g = gidx if dt == "int32" else tsi.index_int64(gidx)
            sfm = tsi.build_sharded_fm(g, ["cuda:0"] * 2, "sampled")
            out.append(measure(f"header resident 2 shards {dt}", Walker(lib, fm, sfm=sfm), rows,
                               want, steps))
        if args.compare is not None:
            from .bench_kernels import load_kernels_module

            other = load_kernels_module(os.path.join(args.compare, "kart_tpu_torch", "kernels.py"),
                                        "kart_tpu_torch_compared_kernels")
            other.build()
            if not torch.equal(other.sa_walk(fm, rows)[0], want[0]):
                raise AssertionError("stamp_walk: the compared build's sa_walk differs")
            t = [time_both(lambda: other.sa_walk(fm, rows)), time_both(lambda: kernels.sa_walk(fm, rows)),
                 time_both(lambda: kernels.sa_walk(fm, rows)),
                 time_both(lambda: other.sa_walk(fm, rows))]
            rec = dict(name=f"compare sa_walk {dt}", longest=int(steps.max()),
                       other_this_this_other_ms=[1e3 * a for a, _ in t],
                       per_call_ms=[1e3 * b for _, b in t])
            print(json.dumps(rec))
            out.append(rec)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(device=smi, records=out), f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
