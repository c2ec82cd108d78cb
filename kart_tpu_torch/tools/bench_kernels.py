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
memory (csrc/probe_latency.cu), which turns a kernel's longest chain of
dependent loads into a time; `device_us_by_kernel` splits a wrapper's call
into its launches' device times with `torch.profiler`.  chip_smoke.py's
phase 4 uses all of them; no function here runs without a CUDA device.
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


def time_both(fn, reps: int = 32) -> tuple[float, float]:
    """(seconds per call by slope over CUDA graphs, seconds per call by one
    event window around `reps` eager calls) of fn()."""
    slope = bench_gather.time_slope(bench_gather.graph_run("kernel", lambda k: fn()))
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
    `torch.profiler` over `reps` eager calls.  Raises if the profiler saw no
    device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
            out[ev.key] = ev.self_device_time_total / reps
    if not out:
        raise RuntimeError("torch.profiler recorded no device activity")
    return out


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time the card could take for work that must move n_bytes
    and do n_ops operations, in ms, and which of the two sets it."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / OPS_PER_S
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def load_kernels_module(path: str, name: str):
    """The `kernels.py` at `path` as a module of its own; it builds the
    sources beside it into the `_build/` beside it."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def dependent_load_ns(n: int = 1 << 26, steps: int = 20000, seed: int = 0) -> float:
    """ns per dependent load over a random single cycle through n int32
    (256 MB at the default, beyond the 50 MB L2)."""
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
