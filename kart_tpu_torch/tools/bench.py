"""Mapping throughput of the port: the three lines of the repository's
bench.py, on the CUDA card or, with --cpu, on the CPU.

Counterpart of root `bench.py::main`, on TorchKartMapper.  It maps bench.py's
data (tools/simdata: the seed-7 E. coli-scale repeat genome, its 100,000
read pairs of 150 bp and 1,500 PacBio reads of 5-7 kb) or the files given,
and prints one JSON line per metric, in bench.py's order, each the median
over timed passes after an untimed priming pass, with the least and most
pass in `spread`:

  illumina_pe_reads_per_sec_device_pipelined
      KART_SEED_MODE=device: the funnel, resolution and packing on the card
      (the kernels' plain versions under --cpu), the C++ post-seeding engine
      on the host; DEVICE_PASSES passes.  This is the card's own line.
  pacbio_reads_per_sec_per_chip
      -pacbio in the native mode, PB_PASSES passes; `device_pb_reads_per_sec`
      the same reads with KART_SEED_MODE=device (SensitiveMode funnel
      seeding), PB_DEVICE_PASSES passes.
  illumina_pe_reads_per_sec_per_chip
      the headline, printed last: the native mode, N_PASSES passes.  It
      measures the port's host C++ engine, as bench.py's headline measures
      kart-tpu's; the card takes no part in it.

Every pass checks that it mapped every read (2 x the pairs, or the PacBio
reads) and wrote SAM text.  Departures from bench.py: no `relay_d2h_MBps`;
no recorded fallback baseline: where the reference binary
.refbuild/bin/kart exists, its passes run interleaved with the port's as in
bench.py (`vs_baseline` the median of the per-pass ratios), and where it is
absent `vs_baseline` and `baseline_reads_per_sec` are null; `bases_per_sec`
is over the PacBio file's mean read length; every line carries `device`,
nvidia-smi's name and power limit of the card (or "cpu"); and a failed run
raises and exits non-zero instead of printing a line whose value is null.
The set-up seconds (index load, mappers, warm-up), the device mappers'
dispatch groups (flagged lanes, lanes re-seeded on the card and on the host)
and the kernels' launches in the timed device passes go to stderr, as one
JSON line.

    python -m kart_tpu_torch.tools.bench [--cpu]
        [--index PREFIX --reads R1 R2 --pacbio PB.fq]

Without --index the assets are made or found in bench_data/ of the
repository.  Without --cpu and without a CUDA device it exits non-zero and
measures nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

from . import profile_device, simdata
from .profile_device import DATA, REPO, environ

N_PASSES = 7  # the headline's passes (bench.py's N_PASSES)
DEVICE_PASSES = 5
PB_PASSES = 3
PB_DEVICE_PASSES = 2
WARM_READS = 512  # the warm-up's reads of each file
REF_KART = os.path.join(REPO, ".refbuild", "bin", "kart")
METRICS = ("illumina_pe_reads_per_sec_device_pipelined", "pacbio_reads_per_sec_per_chip",
           "illumina_pe_reads_per_sec_per_chip")
NO_REFERENCE = "reference binary .refbuild/bin/kart absent: no baseline measured"


def mean_read_length(path: str) -> float:
    with open(path, "rb") as f:
        lens = [len(ln.rstrip(b"\n")) for i, ln in enumerate(f) if i % 4 == 1]
    return sum(lens) / len(lens)


def head_fastq(src: str, dst: str, n_reads: int) -> str:
    """The first n_reads records of `src` as the file `dst`; returns dst."""
    with open(src, "rb") as f, open(dst, "wb") as g:
        for _ in range(4 * n_reads):
            line = f.readline()
            if not line:
                break
            g.write(line)
    return dst


def pacbio_reads(args) -> str:
    """--pacbio, or bench.py's PacBio reads in bench_data/ (made where missing)."""
    if args.pacbio is not None:
        return args.pacbio
    pb = os.path.join(DATA, "bench_pb.fq")
    if simdata.count_reads(pb) != simdata.PB_N_READS:
        fa = os.path.join(DATA, "bench_genome_v2.fa")
        simdata.simulate_pacbio_reads(simdata.read_genome_fasta(fa), pb)
    return pb


def device_label(device: torch.device) -> str:
    """nvidia-smi's name and power limit of the card, or "cpu"."""
    if device.type == "cpu":
        return "cpu"
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return lines[torch.cuda.current_device()]


def discard(_s) -> None:
    pass


def timed_pass(mapper, r1: str, r2: str | None, expect: int) -> float:
    """Reads/s of one whole mapping of r1 (and r2: paired-end); raises
    unless it mapped `expect` reads and wrote SAM text."""
    total0 = mapper.stats["total"]
    out_chars = 0

    def writer(s):
        nonlocal out_chars
        out_chars += len(s)

    t0 = time.perf_counter()
    mapper.map_stream(r1, r2, r2 is not None, True, writer)
    dt = time.perf_counter() - t0
    n_reads = mapper.stats["total"] - total0
    if out_chars <= 0 or n_reads != expect:
        raise RuntimeError(f"a pass mapped {n_reads} reads of {expect} and wrote {out_chars}"
                           " SAM characters")
    return n_reads / dt


def run_reference(argv: list[str]) -> float:
    """Seconds of one run of the reference binary."""
    t0 = time.perf_counter()
    subprocess.run([REF_KART, "-t", "16", *argv, "-o", os.devnull, "-silent"], check=True,
                   capture_output=True)
    return time.perf_counter() - t0


def reference_startup(argv: list[str]) -> float:
    """The reference binary's start-up: the least of two runs on one read,
    after one that fills the page cache."""
    run_reference(argv)
    return min(run_reference(argv) for _ in range(2))


def reference_runner(prefix: str, r1: str, r2: str, n_reads: int, tmp: str):
    """bench.py's make_reference_runner: a callable that times one pass of
    the reference binary at -t 16 over r1 and r2 (reads/s, start-up taken
    off), or None where the binary is absent."""
    if not os.path.exists(REF_KART):
        return None
    startup = reference_startup(["-i", prefix, "-f", head_fastq(r1, os.path.join(tmp, "one1.fq"), 1),
                                 "-f2", head_fastq(r2, os.path.join(tmp, "one2.fq"), 1)])

    def one_pass() -> float:
        return n_reads / max(run_reference(["-i", prefix, "-f", r1, "-f2", r2]) - startup, 0.001)

    return one_pass


def reference_pacbio(prefix: str, pb: str, n_reads: int, tmp: str) -> float | None:
    """bench.py's measure_reference_pacbio: the median reads/s of 3 runs of
    the reference binary with -pacbio at -t 16, start-up taken off, or None
    where the binary is absent."""
    if not os.path.exists(REF_KART):
        return None
    startup = reference_startup(["-pacbio", "-i", prefix, "-f",
                                 head_fastq(pb, os.path.join(tmp, "one_pb.fq"), 1)])
    rates = [n_reads / max(run_reference(["-pacbio", "-i", prefix, "-f", pb]) - startup, 0.001)
             for _ in range(3)]
    return statistics.median(rates)


def group_totals(mapper, start: int) -> dict:
    """The device-pipelined mode's dispatch groups from the start-th on, summed."""
    log = mapper.group_log[start:]
    return dict(groups=len(log), reads=sum(g["reads"] for g in log),
                flagged=sum(g["flagged"] for g in log),
                reseeded_device=sum(g["reseeded_device"] for g in log),
                reseeded_host=sum(g["reseeded_host"] for g in log))


def launch_counters() -> dict:
    """Every kernel wrapper of kart_tpu_torch.kernels by name."""
    from .. import kernels

    return {n: f for n, f in vars(kernels).items() if callable(f) and hasattr(f, "launches")}


def spread(rates: list[float]) -> list[float]:
    return [min(rates), max(rates)]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    profile_device.add_input_args(ap)
    ap.add_argument("--pacbio", default=None, metavar="PATH",
                    help="PacBio reads (default: the bench's 1,500 reads)")
    args = ap.parse_args(argv)
    if args.index is not None and args.pacbio is None:
        raise SystemExit("--index needs --pacbio PATH")
    from ..pipeline.mapper import TorchKartMapper

    t0 = time.perf_counter()
    device, gidx, r1, r2 = profile_device.inputs(args)
    pb = pacbio_reads(args)
    setup = {"inputs_s": time.perf_counter() - t0}  # assets made where missing, index loaded
    label = device_label(device)
    prefix = gidx.raw.prefix
    n_pairs, n_pb = simdata.count_reads(r1), simdata.count_reads(pb)
    if n_pairs == 0 or simdata.count_reads(r2) != n_pairs or n_pb == 0:
        raise SystemExit(f"{r1} and {r2} must hold the same number of reads, and {pb} some")
    where = "the card" if device.type == "cuda" else "the CPU, by the kernels' plain versions"
    counters = launch_counters()
    stderr = {}
    # every native pass runs without KART_SEED_MODE; the device passes set it
    with tempfile.TemporaryDirectory() as tmp, environ({"KART_SEED_MODE": None}):
        t0 = time.perf_counter()
        mapper = TorchKartMapper(gidx, device=device)
        w1 = head_fastq(r1, os.path.join(tmp, "warm_r1.fq"), WARM_READS)
        w2 = head_fastq(r2, os.path.join(tmp, "warm_r2.fq"), WARM_READS)
        mapper.map_stream(w1, w2, True, True, discard)
        setup["native_mapper_s"] = time.perf_counter() - t0
        ref_pass = reference_runner(prefix, r1, r2, 2 * n_pairs, tmp)

        # the device-pipelined line; KART_SEED_MODE is read at every pass
        with environ({"KART_SEED_MODE": "device"}):
            t0 = time.perf_counter()
            dev = TorchKartMapper(gidx, device=device)
            dev.prepare()
            dev.map_stream(w1, w2, True, True, discard)
            setup["device_mapper_s"] = time.perf_counter() - t0
            dev.map_stream(r1, r2, True, True, discard)  # prime
            for f in counters.values():
                f.launches = 0
            start = len(dev.group_log)
            dev_rates, dev_ratios = [], []
            for _ in range(DEVICE_PASSES):
                dev_rates.append(timed_pass(dev, r1, r2, 2 * n_pairs))
                if ref_pass is not None:
                    dev_ratios.append(dev_rates[-1] / ref_pass())
            stderr["launches"] = {n: f.launches for n, f in counters.items() if f.launches}
            stderr["device_groups"] = group_totals(dev, start)
        print(json.dumps({
            "metric": METRICS[0],
            "value": statistics.median(dev_rates),
            "unit": "reads/s",
            "vs_baseline": statistics.median(dev_ratios) if dev_ratios else None,
            "spread": spread(dev_rates),
            "note": f"KART_SEED_MODE=device: funnel seeding, occurrence resolution and packing"
                    f" on {where}, the C++ post-seeding engine on the host; {2 * n_pairs} reads,"
                    f" median of {DEVICE_PASSES} passes after a priming pass; vs_baseline: the"
                    " same-window interleaved reference -t16 (median of per-pass ratios)"
                    + ("" if ref_pass is not None else ", null: " + NO_REFERENCE),
            "device": label,
        }), flush=True)

        # the PacBio line: the native engine, then the device-pipelined mode
        pb_mapper = TorchKartMapper(gidx, device=device, pacbio=True)
        pb_mapper.map_stream(pb, None, False, True, discard)  # prime
        pb_rates = [timed_pass(pb_mapper, pb, None, n_pb) for _ in range(PB_PASSES)]
        pb_ref = reference_pacbio(prefix, pb, n_pb, tmp)
        with environ({"KART_SEED_MODE": "device"}):
            dpb = TorchKartMapper(gidx, device=device, pacbio=True)
            dpb.map_stream(pb, None, False, True, discard)  # prime
            start = len(dpb.group_log)
            dpb_rates = [timed_pass(dpb, pb, None, n_pb) for _ in range(PB_DEVICE_PASSES)]
            stderr["device_pb_groups"] = group_totals(dpb, start)
        pb_median = statistics.median(pb_rates)
        mean_len = mean_read_length(pb)
        print(json.dumps({
            "metric": METRICS[1],
            "value": pb_median,
            "unit": "reads/s",
            "bases_per_sec": pb_median * mean_len,
            "vs_baseline": pb_median / pb_ref if pb_ref else None,
            "baseline_reads_per_sec": pb_ref,
            "device_pb_reads_per_sec": statistics.median(dpb_rates),
            "spread": spread(pb_rates),
            "note": f"{n_pb} PacBio reads of {mean_len:.1f} bases on average, native engine,"
                    f" median of {PB_PASSES} passes; device_pb: KART_SEED_MODE=device"
                    f" (SensitiveMode funnel seeding on {where}), median of {PB_DEVICE_PASSES};"
                    " vs_baseline: the same-window reference -pacbio -t16"
                    + ("" if pb_ref is not None else ", null: " + NO_REFERENCE),
            "device": label,
        }), flush=True)

        # the headline: the native engine, interleaved with the reference's passes
        mapper.map_stream(r1, r2, True, True, discard)  # prime
        rates, ratios, refs = [], [], []
        for _ in range(N_PASSES):
            rates.append(timed_pass(mapper, r1, r2, 2 * n_pairs))
            if ref_pass is not None:
                refs.append(ref_pass())
                ratios.append(rates[-1] / refs[-1])
    stderr["setup_s"] = setup
    print(json.dumps(stderr), file=sys.stderr, flush=True)
    print(json.dumps({
        "metric": METRICS[2],
        "value": statistics.median(rates),
        "unit": "reads/s",
        "vs_baseline": statistics.median(ratios) if ratios else None,
        "spread": spread(rates),
        "baseline_reads_per_sec": statistics.median(refs) if refs else None,
        "baseline_source": ("same-window interleaved reference -t16 (median of per-pair ratios)"
                            if ratios else NO_REFERENCE),
        "device": label,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
