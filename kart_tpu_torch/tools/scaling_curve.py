"""Shard-count throughput curve of the port's seeding step
(parallel/dp.py::make_mapping_step).

Counterpart of the repository's root tools/scaling_curve.py (kart_tpu's,
which measures its jitted step on an 8-device virtual CPU mesh): the same
step at 1, 2, 4 and 8 data blocks, and at the 4 x 2 data x idx
sharded-index mesh, with a fixed total batch (strong scaling), on the same
repeat-bearing genome (1 Mbp; 200 kb with --quick) and the same batch
(2,048 reads of 128 bases; 512 with --quick).

Every mesh position sits on one device: cuda:0, or the CPU with --cpu.  So
the curve isolates what the mesh itself costs on that device (smaller
blocks, the sharded index's masked lookups and per-step sums), not scaling:
one card cannot measure scaling across cards, and a flat curve means the
split costs nothing.  The first line, before the JSON, names the device and
how many positions share it.  Without --cpu and without a CUDA device it
exits non-zero and measures nothing.

    python -m kart_tpu_torch.tools.scaling_curve [--cpu] [--quick]

Prints one JSON line per mesh:
  {"mesh": "data=2", "reads_per_sec": N, "step_ms": M, "rel_vs_1shard": R, "seeds": S}
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time

import numpy as np

from ..parallel import make_data_mesh, make_mapping_step
from .bench_scaling import CONFIGS, device_line, sync
from .profile_device import device_for


def build_workload(tmpdir: str, quick: bool):
    """A small repeat-bearing genome + read batch (root scaling_curve's)."""
    from ..index import build_index, load_index

    rng = np.random.default_rng(11)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    glen = 200_000 if quick else 1_000_000
    seq = rng.choice(bases, size=glen)
    rep = rng.choice(bases, size=800)
    for _ in range(6):  # dispersed repeats for OCC pressure
        p = int(rng.integers(0, glen - 800))
        seq[p : p + 800] = rep
    fa = os.path.join(tmpdir, "scal.fa")
    with open(fa, "wb") as f:
        f.write(b">scal\n")
        s = seq.tobytes()
        for j in range(0, len(s), 70):
            f.write(s[j : j + 70] + b"\n")
    prefix = os.path.join(tmpdir, "scal")
    build_index(fa, prefix, verbose=False)
    gidx = load_index(prefix)

    batch = 512 if quick else 2048
    rlen = 128
    reads = np.zeros((batch, rlen), dtype=np.uint8)
    code = {65: 0, 67: 1, 71: 2, 84: 3}
    codes = np.zeros(256, np.uint8)
    for k, v in code.items():
        codes[k] = v
    for i in range(batch):
        p = int(rng.integers(0, glen - rlen))
        reads[i] = codes[seq[p : p + rlen]]
    rlens = np.full((batch,), rlen, dtype=np.int32)
    return gidx, reads, rlens


def time_mesh(gidx, reads, rlens, n_data: int, n_idx: int, passes: int, dev):
    mesh = make_data_mesh(n_data, n_idx, devices=[dev] * (n_data * n_idx))
    step, place = make_mapping_step(
        mesh,
        gidx,
        idx_axis="idx" if n_idx > 1 else None,
        min_seed_len=16,
        max_seeds=32,
        l_max=reads.shape[1],
    )
    dr, dl = place(reads, rlens)
    out = step(dr, dl)  # warm: kernels built and loaded
    sync(dev)
    times = []
    for _ in range(passes):
        t0 = time.perf_counter()
        out = step(dr, dl)
        sync(dev)
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    total = int(out[2])
    assert total > 0, "mapping step produced no seeds"
    return dt, total


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="tiny shapes (CI)")
    ap.add_argument("--cpu", action="store_true", help="put every mesh position on the CPU")
    args = ap.parse_args(argv)
    dev = device_for(args.cpu)

    passes = 3 if args.quick else 7
    with tempfile.TemporaryDirectory() as td:
        gidx, reads, rlens = build_workload(td, args.quick)
        batch = reads.shape[0]
        print(device_line(dev, max(d * i for d, i in CONFIGS)), flush=True)
        base = None
        for n_data, n_idx in CONFIGS:
            dt, total = time_mesh(gidx, reads, rlens, n_data, n_idx, passes, dev)
            rps = batch / dt
            if base is None:
                base = rps
            name = f"data={n_data}" + (f" x idx={n_idx}" if n_idx > 1 else "")
            print(
                json.dumps(
                    {
                        "mesh": name,
                        "reads_per_sec": round(rps, 1),
                        "step_ms": round(dt * 1e3, 2),
                        "rel_vs_1shard": round(rps / base, 3),
                        "seeds": total,
                    }
                ),
                flush=True,
            )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
