"""Capture and analyse a device trace of one funnel group of the port's
device-pipelined mode.

Counterpart of kart_tpu's `tools/analyze_trace.py`.  `capture` runs the
mapper's own `_seed_resolved` on one group of bench.py's reads (the 13-mer
funnel and resolve_pack, kart_tpu's `kmer_seed_scan_resolved_packed`) `reps`
times under `utils/trace.device_trace`, which writes a torch.profiler Chrome
trace; `analyze` reads the newest trace under a directory and prints the top
device ops by total time: total us, calls, us per rep and name.  kart_tpu's
total also summed host lanes; this one sums device lanes only (kernels,
copies and sets: the trace's `kernel`, `gpu_memcpy` and `gpu_memset`
events, read by `utils/trace.trace_spans`, the parser that
`tools/bench_kernels.device_spans` uses too) and gives the device's busy
time beside it (`bench_kernels.busy_seconds`, the union of the spans).

    python -m kart_tpu_torch.tools.analyze_trace [--top 25] [--reps 3] [--dir DIR]
        [--group 8] [--cpu] [--index PREFIX --reads R1 R2]

Without --cpu and without a CUDA device it exits non-zero and captures
nothing; with --cpu the plain versions run on the CPU, whose trace has no
device lanes.
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import sys
import tempfile
from collections import defaultdict

def capture(trace_dir: str, mapper, r1: str, r2: str, *, reps: int = 3, group: int = 8) -> int:
    """Trace `reps` runs of one funnel group of G = `group` chunks (the
    mapper's _seed_resolved, its inputs already on the device) into
    trace_dir; returns reps."""
    import torch

    from ..ops.pack import pack_reads_2bit
    from ..utils.trace import device_trace
    from .profile_device import read_group

    if mapper._get_kmer_tables() is None:
        raise SystemExit("capture: the funnel's tables fail the gate on this index")
    with read_group(mapper, r1, r2, group) as (_, reads_i8, rl, l_max, _, _):
        B = reads_i8.shape[0]
        (w, ar, ap, r), _ = mapper._to_device(pack_reads_2bit(reads_i8) + (rl,))

        def go():
            return mapper._seed_resolved(w, ar, ap, r, l_max, B)

        go()  # warm
        if mapper.device.type == "cuda":
            torch.cuda.synchronize()
        with device_trace(trace_dir):
            for _ in range(reps):
                go()
    return reps


def load_trace(trace_dir: str) -> dict | None:
    """The newest Chrome trace (`*.json` or `*.json.gz`) under trace_dir."""
    paths = [p for pat in ("*.json", "*.json.gz")
             for p in glob.glob(os.path.join(trace_dir, "**", pat), recursive=True)]
    if not paths:
        return None
    path = max(paths, key=os.path.getmtime)
    with (gzip.open(path, "rt") if path.endswith(".gz") else open(path)) as f:
        return json.load(f)


def analyze(trace_dir: str, top: int, reps: int) -> dict | None:
    """Print the top device ops of the newest trace under trace_dir by
    total time -> dict(rows [(name, calls, us total, us per rep)],
    device_us (the sum over device events), busy_us (their union), events
    (all complete events of the trace)); None where no trace is found."""
    from ..utils.trace import trace_spans
    from .bench_kernels import busy_seconds

    trace = load_trace(trace_dir)
    if trace is None:
        print("no trace found under", trace_dir, file=sys.stderr)
        return None
    spans = trace_spans(trace)
    us, calls = defaultdict(float), defaultdict(int)
    for t0, t1, name in spans:
        us[name] += t1 - t0
        calls[name] += 1
    rows = [(name, calls[name], us[name], us[name] / reps)
            for name in sorted(us, key=lambda k: -us[k])[:top]]
    total = sum(us.values())
    busy = 1e6 * busy_seconds(spans)[0] if spans else 0.0
    n_events = sum(1 for ev in trace.get("traceEvents", []) if ev.get("ph") == "X")
    print(f"{'us_total':>12} {'calls':>7} {'us/rep':>10}  op")
    for name, n, t, per in rows:
        print(f"{t:12.1f} {n:7d} {per:10.2f}  {name[:110]}")
    if spans:
        print(f"# device total {total:.1f} us over {reps} reps ({total / reps / 1e3:.4f} ms/rep;"
              f" device lanes only: kernels, copies, sets); busy {busy:.1f} us (their union)")
    else:
        print(f"# no device events among the trace's {n_events} (a CPU run has none)")
    return dict(rows=rows, device_us=total, busy_us=busy, events=n_events)


def main(argv: list[str] | None = None) -> int:
    from . import profile_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--dir", default=None)
    ap.add_argument("--group", type=int, default=8)
    profile_device.add_input_args(ap)
    args = ap.parse_args(argv)
    device, gidx, r1, r2 = profile_device.inputs(args)
    mapper = profile_device.make_mapper(gidx, "kmer", device)
    d = args.dir or tempfile.mkdtemp(prefix="kart_trace_")
    reps = capture(d, mapper, r1, r2, reps=args.reps, group=args.group)
    out = analyze(d, args.top, reps)
    return 1 if out is None or (device.type == "cuda" and not out["rows"]) else 0


if __name__ == "__main__":
    sys.exit(main())
