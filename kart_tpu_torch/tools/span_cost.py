"""What one `utils.trace.span` costs the host, off and on.

    python -m kart_tpu_torch.tools.span_cost [--n 200000]

Times `--n` empty spans in each state, the best of `--reps` runs, less the
same loop around a bare shared no-op context for the off state and the
bare loop for the rest: off (KART_TIMERS unset, no profiler), the recorder
on (as with KART_TIMERS=1), and under a CPU `torch.profiler` session
without and with shapes recorded; beside them one
`torch.profiler.record_function` under the session.  Prints one JSON line
of microseconds a span, with the machine's CPU model.  Host only: it
touches no device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import platform
import time

import torch

from ..utils import trace


def _per_call_us(loop, n: int, reps: int) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        loop(n)
        best = min(best, time.perf_counter() - t0)
    return 1e6 * best / n


def _spans(n: int) -> None:
    for i in range(n):
        with trace.span("kart.cost", i):
            pass


def _bare(n: int) -> None:
    for i in range(n):
        pass


def _noop(n: int) -> None:
    ctx = contextlib.nullcontext()
    for i in range(n):
        with ctx:
            pass


def _record_function(n: int) -> None:
    for i in range(n):
        with torch.profiler.record_function("kart.cost"):
            pass


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or "unknown"


def measure(n: int, reps: int = 3) -> dict:
    """Microseconds a span in each state (see the module's docstring)."""
    from torch.profiler import ProfilerActivity, profile

    timers = trace.TIMERS
    saved = timers.enabled
    out = {"spans": n, "cpu": _cpu_model(), "torch": torch.__version__}
    try:
        timers.enabled = False
        bare, noop = _per_call_us(_bare, n, reps), _per_call_us(_noop, n, reps)
        out["off_us"] = _per_call_us(_spans, n, reps) - bare
        out["shared_noop_us"] = noop - bare
        timers.enabled = True
        out["recorder_us"] = _per_call_us(_spans, n, reps) - bare
        timers.enabled = False
        for shapes in (False, True):
            with profile(activities=[ProfilerActivity.CPU], record_shapes=shapes):
                key = "profiler_shapes_us" if shapes else "profiler_us"
                out[key] = _per_call_us(_spans, n // 10, 1) - bare
                if not shapes:
                    out["record_function_us"] = _per_call_us(_record_function, n // 10, 1) - bare
    finally:
        timers.enabled = saved
        timers.acc.pop("kart.cost", None)
        timers.n.pop("kart.cost", None)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=200000)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    print(json.dumps(measure(args.n, args.reps)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
