"""How often a torch.profiler session loses the device's records, with and
without `bench_kernels.PROFILER_PAD_S`, on one CUDA card, and how far the
profiler places a kernel from its launch as the process ages.

    python -m kart_tpu_torch.tools.profiler_probe --seconds 300

For `--seconds`, it takes `bench_kernels.device_spans` sessions in turns
with pad 0 and with the default pad.  Each session's step launches two small
kernels, and the device then does some other work and idles half a second
before the next pair of sessions.  It prints the card's `nvidia-smi` name and
power limit, then one JSON line for each pad: the sessions taken, those in
which a launch had no device event (`device_spans` raised), and the time
from the probe's start to the first of them; then one JSON line for each
`--bucket` seconds: the least and most us from a launch to its kernel's
start over the sessions that ended in it (`bench_kernels.PROFILER_OFFSETS`).
Without a CUDA device it raises.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from .bench_kernels import PROFILER_OFFSETS, PROFILER_PAD_S, LostRecords, device_spans


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=300.0)
    ap.add_argument("--bucket", type=float, default=60.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profiler_probe: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"profiler_probe: {smi}")
    x = torch.zeros(1 << 20, device="cuda")

    def step():
        x.add_(1)
        x.mul_(2)

    pads = (0.0, PROFILER_PAD_S)
    rec = {p: dict(pad_s=p, sessions=0, lost=0, first_lost_s=None) for p in pads}
    t0 = time.monotonic()
    while time.monotonic() - t0 < args.seconds:
        for p in pads:
            r = rec[p]
            r["sessions"] += 1
            try:
                device_spans(step, warm=step, pad=p, tries=1)
            except LostRecords:
                r["lost"] += 1
                if r["first_lost_s"] is None:
                    r["first_lost_s"] = time.monotonic() - t0
        for _ in range(50):
            step()
        torch.cuda.synchronize()
        time.sleep(0.5)
    for p in pads:
        print(json.dumps(rec[p]))
    buckets: dict[int, list] = {}
    for t, lo, hi in PROFILER_OFFSETS:
        b = buckets.setdefault(int((t - t0) // args.bucket), [lo, hi])
        b[0], b[1] = min(b[0], lo), max(b[1], hi)
    for k in sorted(buckets):
        print(json.dumps(dict(from_s=k * args.bucket, least_us=buckets[k][0],
                              most_us=buckets[k][1])))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
