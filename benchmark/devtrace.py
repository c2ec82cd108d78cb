"""The traced run's device records: one `torch.profiler` session over a
stretch of the timed loop, checked for lost records, and read into device
spans, the device time of every op by its own name, the busy share and the
breakdown.  A per-layer metric picks its own ops by name (`op_ms`), so a
metric of another layer needs no edit here.

A session can lose the device's records of its step: the profiler places
a kernel up to a millisecond off its launch and drops one outside the
step's window.  So the device idles `PAD_S`
around the step's edges, as `kart_tpu_torch/tools/bench_kernels.py::
device_spans` does, and every runtime call that queues device work in the
step (a launch, a copy, a set) must have a device record of its correlation
id.  A session that lost any is taken again, up to `TRIES` in all; then
the run fails rather than report short times.
"""

from __future__ import annotations

import bisect
import json
import os
import sys
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
QUEUE_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
               "cudaMemcpyAsync", "cudaMemsetAsync", "cuMemcpyAsync", "cuMemsetD8Async",
               "cuMemsetD32Async")
PAD_S = 0.5
TRIES = 3
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver", "python_function")
# host events before a gap searched for the innermost one around its start
LOOK_BACK = 256


class LostRecords(RuntimeError):
    """A session lost device records of its step."""


def read_trace(trace: dict) -> dict:
    """Device events (a set with `before`, the name of the next kernel on its
    stream), host events, and the queueing calls that have no device
    record."""
    evs = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X" and "dur" in e]
    dev, host, seen = [], [], set()
    for e in evs:
        cat = e.get("cat")
        rec = dict(t0=float(e["ts"]), t1=float(e["ts"]) + float(e["dur"]), name=e.get("name", "?"),
                   cat=cat, corr=e.get("args", {}).get("correlation"),
                   stream=e.get("args", {}).get("stream"))
        if cat in DEVICE_CATS:
            dev.append(rec)
            seen.add(rec["corr"])
        elif cat in HOST_CATS:
            host.append(rec)
    dev.sort(key=lambda r: r["t0"])
    by_stream: dict = {}
    for r in dev:
        by_stream.setdefault(r["stream"], []).append(r)
    for rs in by_stream.values():
        nxt = None
        for r in reversed(rs):
            if r["cat"] == "kernel":
                nxt = r["name"]
            elif r["cat"] == "gpu_memset":
                r["before"] = nxt
    lost = [h for h in host if h["cat"] in ("cuda_runtime", "cuda_driver")
            and h["name"] in QUEUE_CALLS and h["corr"] not in seen]
    return dict(device=dev, host=host, lost=lost)


def busy_union(spans, t0: float, t1: float) -> float:
    """Microseconds of [t0, t1] covered by the spans' union."""
    busy, cur0, cur1 = 0.0, None, None
    for s in sorted((max(a, t0), min(b, t1)) for a, b in spans if b > t0 and a < t1):
        if cur1 is None or s[0] > cur1:
            if cur1 is not None:
                busy += cur1 - cur0
            cur0, cur1 = s
        else:
            cur1 = max(cur1, s[1])
    if cur1 is not None:
        busy += cur1 - cur0
    return busy


def idle_gaps(dev, host, t0: float, t1: float) -> list:
    """(what the host was doing, microseconds) of every gap in the device's
    busy union inside [t0, t1]: the innermost of the LOOK_BACK host events
    begun last before the gap's start that are still open there, or
    "_none_"."""
    spans = sorted((max(d["t0"], t0), min(d["t1"], t1)) for d in dev if d["t1"] > t0 and d["t0"] < t1)
    gaps, cur = [], t0
    for a, b in spans:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if t1 > cur:
        gaps.append((cur, t1))
    hs = sorted(host, key=lambda h: h["t0"])
    starts = [h["t0"] for h in hs]
    out = []
    for a, b in gaps:
        i = bisect.bisect_right(starts, a)
        inner = [h for h in hs[max(0, i - LOOK_BACK) : i] if a < h["t1"]]
        name = min(inner, key=lambda h: h["t1"] - h["t0"])["name"] if inner else "_none_"
        out.append((name, b - a))
    return out


def op_us(dev) -> tuple:
    """(device microseconds of every op by its own name, of the sets by the
    name of the kernel each precedes on its stream)."""
    ops, sets = {}, {}
    for d in dev:
        ops[d["name"]] = ops.get(d["name"], 0.0) + d["t1"] - d["t0"]
        if d["cat"] == "gpu_memset" and d.get("before"):
            sets[d["before"]] = sets.get(d["before"], 0.0) + d["t1"] - d["t0"]
    return ops, sets


def op_ms(trace: dict, names, with_sets: bool = True):
    """Device milliseconds a group of the traced stretch's ops whose own
    name holds one of `names`, with the sets queued just before those
    kernels; None where none ran or no group finished."""
    if trace is None or not trace["groups"]:
        return None
    hit = [k for k in trace["op_us"] if any(n in k for n in names)]
    if not hit:
        return None
    us = sum(trace["op_us"][k] for k in hit)
    if with_sets:
        us += sum(v for k, v in trace["set_us"].items() if k in hit)
    return us / 1e3 / trace["groups"]


def top(pairs, n: int = 10) -> list:
    """The n largest totals of (name, value) pairs, in seconds."""
    acc: dict = {}
    for k, v in pairs:
        acc[k] = acc.get(k, 0.0) + v
    return [[k, v / 1e6] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:n]]


def profile_session(step, warm, out_dir: str) -> dict:
    """One session: warm() as the profiler's warm-up step, then step() in
    the active one, the device idle PAD_S around its edges; its records
    read by read_trace, taken again up to TRIES sessions while any
    queueing call lost its device record."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    for attempt in range(TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            warm()
            torch.cuda.synchronize()
            time.sleep(PAD_S)
            prof.step()
            time.sleep(PAD_S)
            info = step()
            torch.cuda.synchronize()
            time.sleep(PAD_S)
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            rec = read_trace(json.load(f))
        os.remove(path)
        n_queue = sum(1 for h in rec["host"] if h["name"] in QUEUE_CALLS)
        if rec["device"] and not rec["lost"]:
            rec["info"] = info
            rec["queued"] = n_queue
            return rec
        msg = (f"torch.profiler lost the device records of {len(rec['lost'])} of {n_queue}"
               f" queueing calls (session {attempt + 1} of {TRIES})")
        print(f"devtrace: {msg}", file=sys.stderr)
    raise LostRecords(msg)
