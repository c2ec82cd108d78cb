"""Timing helpers for the port's kernels on one CUDA card, and the pieces
that put two builds of a kernel side by side in one run.

`time_both(fn)` times fn() two ways: by slope over CUDA graphs of 8 and 136
calls (`bench_gather.time_slope`, device time per call with launch and
replay costs cancelled) and per call by one event window around eager calls
(which also holds the wrapper's host work wherever a call enqueues slower
than it runs).  `load_kernels_module` loads the `kernels.py` of another
checkout of the port (its parent commit, unpacked with `git archive`), which
builds that checkout's sources into its own `_build/`;
`dependent_load_ns` measures the latency of one dependent load from device
memory, or from L2 at a working set that fits it (csrc/probe_latency.cu),
which turns a kernel's longest chain of dependent loads into a time;
`device_us_by_kernel` splits a wrapper's call into its launches' device
times with `torch.profiler`, and `device_spans` with `busy_seconds` gives
the share of a whole run during which the device was busy.  chip_smoke.py's
phases 1, 2, 4, 7 and 8 use them; only `bound_ms` and `busy_seconds` run
without a CUDA device.
"""

from __future__ import annotations

import ctypes
import importlib.util
import os

import numpy as np
import torch

from .. import kernels
from . import bench_gather

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
OPS_PER_S = 67e12  # float32 rate outside the tensor cores, taken for 32-bit integer work too


def time_both(fn, reps: int = 32, n_small: int = 8, n_big: int = 136) -> tuple[float, float]:
    """(seconds per call by slope over CUDA graphs of n_small and n_big
    calls, seconds per call by one event window around `reps` eager calls)
    of fn().  A call of many milliseconds takes fewer of each."""
    slope = bench_gather.time_slope(bench_gather.graph_run("kernel", lambda k: fn()),
                                    n_small, n_big)
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return slope, start.elapsed_time(end) / 1e3 / reps


def device_us_by_kernel(fn, reps: int = 10) -> dict[str, float]:
    """Device microseconds per call of fn(), by kernel or copy name, from
    `torch.profiler` over `reps` eager calls.  A session that saw no device
    activity (a process that has run many sessions and CUDA graphs gave one
    on an H100) is taken once more; raises if that one saw none either."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {}
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
                out[ev.key] = ev.self_device_time_total / reps
        if out:
            return out
    raise RuntimeError("torch.profiler recorded no device activity")


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time the card could take for work that must move n_bytes
    and do n_ops operations, in ms, and which of the two sets it."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / OPS_PER_S
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def load_kernels_module(path: str, name: str):
    """The `kernels.py` at `path` as a module of its own; it builds the
    sources beside it into the `_build/` beside it.  Its relative imports
    (`from .ops...`) resolve to this checkout's package."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    mod.__package__ = __package__.rsplit(".", 1)[0]
    spec.loader.exec_module(mod)
    return mod


def dependent_load_ns(n: int = 1 << 26, steps: int = 20000, seed: int = 0, *,
                      working_set_bytes: int | None = None) -> float:
    """ns per dependent load over a random single cycle through n int32
    (256 MB at the default, beyond the 50 MB L2).  With `working_set_bytes`
    the cycle runs through that many bytes instead: at an index's size, a
    few MB, it gives the latency of a dependent load that hits L2.  The
    table is read once whole before the timed walks, so that a set that fits
    L2 is in it."""
    if working_set_bytes is not None:
        n = max(working_set_bytes // 4, 2 * steps)
    path = os.path.join(kernels.BUILD_DIR, "libkartprobe.so")
    kernels.build(path, [os.path.join(os.path.dirname(kernels.SOURCES[0]), "probe_latency.cu")])
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.kart_probe_chase.argtypes = [p, i, i, p, p]
    lib.kart_probe_chase.restype = i
    perm = np.random.default_rng(seed).permutation(n).astype(np.int32)
    nxt = np.empty(n, np.int32)
    nxt[perm] = np.roll(perm, -1)
    table = torch.from_numpy(nxt).cuda()
    out = torch.empty(1, dtype=torch.int32, device="cuda")
    table.sum()

    def run(k: int) -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        rc = lib.kart_probe_chase(table.data_ptr(), int(perm[0]), k, out.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
        end.record()
        if rc != 0:
            raise RuntimeError(f"probe_latency: CUDA launch failed with cudaError {rc}")
        end.synchronize()
        return start.elapsed_time(end) * 1e6

    run(steps // 10)
    return (run(steps) - run(steps // 10)) / (steps - steps // 10)


def device_spans(fn, warm) -> list[tuple[float, float, str]]:
    """fn() once under `torch.profiler`: the (start us, end us, name) of every
    kernel and copy the device ran, in order of start.  warm() runs first as
    the profiler's warm-up step, whose events are dropped: a profiler started
    cold can lose the device's first events.  Raises if the profiler saw no
    device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        warm()
        torch.cuda.synchronize()
        prof.step()
        fn()
        torch.cuda.synchronize()
    spans = sorted((ev.time_range.start, ev.time_range.end, ev.name) for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA and ev.time_range.end > ev.time_range.start
                   and not ev.name.startswith("ProfilerStep"))
    if not spans:
        raise RuntimeError("torch.profiler recorded no device activity")
    return spans


def busy_seconds(spans) -> tuple[float, float]:
    """(seconds the device was busy: the union of the spans' intervals;
    seconds from the first span's start to the last one's end)."""
    busy, cur0, cur1 = 0.0, spans[0][0], spans[0][1]
    for t0, t1, _ in spans[1:]:
        if t0 > cur1:
            busy += cur1 - cur0
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    busy += cur1 - cur0
    return busy / 1e6, (max(t1 for _, t1, _ in spans) - spans[0][0]) / 1e6
