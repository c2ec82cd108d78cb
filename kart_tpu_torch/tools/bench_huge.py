"""Human-scale (int64) throughput bench of the port: the 1.1 Gbp / 2.2e9-text
index.

Counterpart of kart_tpu's `tools/bench_huge.py`, on TorchKartMapper.  At
that size the funnel's tables gate out (text > KART_KMER_GATE) and the SA
mode is sampled (no `.saf`), so the device-pipelined mode seeds with the FM
stepper and resolves by walks over the sampled SA, in int64; the native mode
runs the C++ FM seeder.  It reads the assets under tests/_work/huge of the
repository (`KART_HUGE_TESTS=1 pytest tests/test_huge_genome.py` builds
them; either package reads the other's index files), and simulates its reads
there with `simulate_reads` where they are missing.

    python -m kart_tpu_torch.tools.bench_huge [--reads 20000] [--passes 3] [--cpu]

Prints one JSON line per mode (native_fm, device_i64), with kart_tpu's
metric names; a mode that fails prints its error line, and the exit code is
then non-zero.  Without --cpu and without a CUDA device it exits non-zero and
measures nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
import traceback

import torch

from .profile_device import device_for, environ

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HUGE = os.path.join(REPO, "tests", "_work", "huge")


def run(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=20000)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--cpu", action="store_true", help="map on the CPU (plain versions)")
    args = ap.parse_args(argv)
    device = device_for(args.cpu)
    prefix = os.path.join(HUGE, "idx")
    if not os.path.exists(prefix + ".bwt"):
        print(json.dumps({"error": "huge assets missing; run KART_HUGE_TESTS=1 pytest tests/test_huge_genome.py first"}))
        return 1
    fa = os.path.join(HUGE, "huge.fa")
    r1 = os.path.join(HUGE, "bench_h1.fq")
    r2 = os.path.join(HUGE, "bench_h2.fq")
    if not os.path.exists(r1):
        from .simulate_reads import simulate

        simulate(fa, r1, r2, n_reads=args.reads, read_len=150, seed=71)

    from ..index import load_index
    from ..pipeline.mapper import TorchKartMapper

    gidx = load_index(prefix)
    failed = 0
    for mode, env in (("native_fm", {}),
                      ("device_i64", {"KART_SEED_MODE": "device"})):
        try:
            with environ(env):
                m = TorchKartMapper(gidx, device=device)
                m.map_stream(r1, r2, True, True, lambda s: None)  # prime
                rates = []
                for _ in range(args.passes):
                    t0 = time.time()
                    tot0 = m.stats["total"]
                    m.map_stream(r1, r2, True, True, lambda s: None)
                    rates.append((m.stats["total"] - tot0) / (time.time() - t0))
            rec = {
                "metric": f"huge_genome_reads_per_sec_{mode}",
                "value": round(statistics.median(rates), 1),
                "unit": "reads/s",
                "genome": "1.1 Gbp (2.2e9 text, i64 index)",
                "spread": [round(min(rates), 1), round(max(rates), 1)],
                "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            }
            print(json.dumps(rec), flush=True)
        except Exception as e:  # one line per mode, as kart_tpu's; the exit code says it failed
            traceback.print_exc()
            failed += 1
            print(json.dumps({"metric": f"huge_genome_reads_per_sec_{mode}",
                              "error": f"{type(e).__name__}: {e}"[:200]}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(run())
