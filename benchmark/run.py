"""Run one cell of BENCHMARK.json once on the CUDA card(s) of this machine.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  With --trace 0 the result reports the cell's
end-to-end metrics, with --trace 1 its per-layer ones.  The last line of
standard output is the result, one JSON object; the numbers compared for
`correct` close standard error and the result line.  Without the cards the
cell asks for, or with jax, jaxlib, flax or kart_tpu loaded when the window
has closed, it prints no result and exits with 2 or 3.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "kart_tpu")


def process_start() -> float:
    """time.time() at this process's start (Linux: /proc), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def loaded_forbidden() -> list:
    """FORBIDDEN modules in sys.modules, compared by whole top-level name
    (kart_tpu_torch is not kart_tpu)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _cache_dirs(root: str) -> None:
    """torch's and Triton's kernel caches inside the checkout, at fixed
    paths, should anything the port loads build there (the port's own
    kernels build into kart_tpu_torch/_build/, inside the checkout too)."""
    base = os.path.join(root, "benchmark", "_cache", "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    found = loaded_forbidden()
    if found:
        print(f"benchmark: {', '.join(found)} loaded before the run", file=sys.stderr)
        return 3

    from benchmark import harness

    _cache_dirs(harness.ROOT)
    bench, cell, config, traffic = harness.load_cell(os.getcwd(), args.workload)
    import torch

    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {chips} CUDA card(s), found {n}",
              file=sys.stderr)
        return 2
    result = harness.run_loaded(
        bench, cell, config, traffic, seed=args.seed, seconds=args.seconds,
        trace=bool(args.trace), device="cuda", t_start=t_start, root=os.getcwd(),
        log=lambda s: print(s, file=sys.stderr))
    found = loaded_forbidden()
    if found:
        print(f"benchmark: {', '.join(found)} loaded in the measured process", file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
