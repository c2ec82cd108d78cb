"""Tracing and profiling helpers of the port.

Counterpart of kart_tpu's `utils/trace.py`.  The reference has no tracing
beyond a wall-clock progress line (src/Mapping.cpp:509) and indexer phase
timers (src/BWT_Index/bwtindex.c:93-145).  This module adds:

  * StageTimers — lightweight named accumulators for the host pipeline
    stages (read / seed / post / emit), printed as a per-read breakdown;
  * span — the program's one span recorder: `with span("kart.seed", g)`
    adds the block's seconds and a count to the module's TIMERS and, under
    an active torch.profiler session, puts a `kart.seed` event (the group
    number in its args) into the trace on the profiler's clock.  Off
    (KART_TIMERS unset at start and no profiler running) it is one check
    and a shared no-op context;
  * setup_span — a span of the process's set-up (the index's load, the
    funnel's tables, the device copies), recorded whatever the switch,
    since set-up runs before any profiler session; `count` sets a counter
    of TIMERS (`index_device_bytes`);
  * device_trace — context manager around torch.profiler that writes a
    Chrome trace of the enclosed block (CPU and, where there is a CUDA
    device, its kernels and copies) into a directory (KART_TRACE_DIR or
    arg), and refuses one that lost the device's records of a block that
    queued device work; tools/analyze_trace.py reads it;
  * trace_spans — the device events of such a trace, the one parser of
    device lanes that the port's tools share;
  * progress_line — the reference's \\r-rewritten progress reporter.

Enable stage timing with KART_TIMERS=1; the native pipeline's own
per-stage profile is KART_PROF=1 (kart_post.cpp).  StageTimers and
progress_line are kart_tpu's, byte for byte in what they print (a
StageTimers with no counter set).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from collections import defaultdict

import torch
from torch._C._profiler import _RecordFunctionFast

# the Chrome trace's device lanes: kernels, copies and sets
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# seconds the device idles around a traced block: a profiler places a
# kernel up to about a millisecond off its launch and drops one outside the
# session's window (PERF.md, section 7)
PAD_S = 0.5


class StageTimers:
    """Named wall-clock accumulators: with timers.stage("seed"): ..."""

    def __init__(self, enabled: bool | None = None):
        self.enabled = (
            enabled if enabled is not None else os.environ.get("KART_TIMERS") == "1"
        )
        self.acc: dict[str, float] = defaultdict(float)
        self.n: dict[str, int] = defaultdict(int)
        self.counters: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.acc[name] += time.perf_counter() - t0
            self.n[name] += 1

    def report(self, n_items: int | None = None, file=sys.stderr) -> None:
        if not self.enabled or not self.acc:
            return
        parts = []
        for k in sorted(self.acc, key=self.acc.get, reverse=True):
            line = f"{k}={self.acc[k]:.3f}s"
            if n_items:
                line += f" ({1e9 * self.acc[k] / n_items:.0f}ns/item)"
            parts.append(line)
        parts += [f"{k}={v}" for k, v in sorted(self.counters.items())]
        print("[kart_timers] " + "  ".join(parts), file=file)


# the spans' recorder, on for the process with KART_TIMERS=1 at start
TIMERS = StageTimers()
_OFF = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled


class _Span:
    """One recording span: seconds and a count into TIMERS on
    time.perf_counter; under an active profiler also a user-scope record
    function of the same name, the group number among its keyword values
    (in the Chrome trace's args where the session records shapes)."""

    __slots__ = ("name", "group", "rec", "t0")

    def __init__(self, name: str, group: int | None):
        self.name, self.group = name, group

    def __enter__(self):
        self.rec = None
        if _profiling():
            kw = {"scope": "user_scope"}
            if self.group is not None:
                kw["group"] = int(self.group)
            self.rec = _RecordFunctionFast(self.name, keyword_values=kw)
            self.rec.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        TIMERS.acc[self.name] += time.perf_counter() - self.t0
        TIMERS.n[self.name] += 1
        if self.rec is not None:
            self.rec.__exit__(*exc)
        return False


def span(name: str, group: int | None = None):
    """A context that records the block as `name` (tagged with `group`, a
    group's sequence number, where given) while KART_TIMERS=1 was set at
    start or a torch.profiler session is active; else a shared no-op."""
    if not (TIMERS.enabled or _profiling()):
        return _OFF
    return _Span(name, group)


def setup_span(name: str) -> _Span:
    """A span of the process's set-up (`kart.index.*`): recorded into TIMERS
    whether or not the recorder is on, and into the trace under an active
    profiler.  A handful a process, so the clock reads cost nothing that
    shows."""
    return _Span(name, None)


def count(name: str, value: int) -> None:
    """Set TIMERS' counter `name` (a level, not a sum: the last value
    stands); the report prints it after the spans."""
    TIMERS.counters[name] = int(value)


def trace_spans(trace: dict) -> list[tuple[float, float, str]]:
    """The (start us, end us, name) of every device event of a Chrome trace
    (its DEVICE_CATS events), in order of start."""
    return sorted((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]), ev.get("name", "?"))
                  for ev in trace.get("traceEvents", [])
                  if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATS and "dur" in ev)


def host_launches(trace: dict) -> int:
    """The CUDA runtime and driver calls of a Chrome trace that queue device
    work: kernel and graph launches, copies and sets."""
    return sum(1 for ev in trace.get("traceEvents", [])
               if ev.get("cat") in ("cuda_runtime", "cuda_driver")
               and any(k in ev.get("name", "") for k in ("Launch", "Memcpy", "Memset")))


def check_device_events(trace: dict, where: str, port_launches: int = 0) -> None:
    """Raise if `trace` holds no device event while the traced block queued
    device work: calls that queue it in the trace, or `port_launches`
    launches that the port's kernel wrappers counted.  Such a session lost
    the device's records (PERF.md, section 7)."""
    n = host_launches(trace) + port_launches
    if n and not trace_spans(trace):
        raise RuntimeError(f"{where}: torch.profiler recorded no device event of a block that"
                           f" queued device work ({host_launches(trace)} launches, copies or sets"
                           f" in the trace, {port_launches} launches of the port's kernels)")


def _port_launches() -> int:
    """The sum of the port's kernel wrappers' launch counts."""
    from .. import kernels

    return sum(getattr(f, "launches", 0) for f in vars(kernels).values() if callable(f))


@contextlib.contextmanager
def device_trace(trace_dir: str | None = None):
    """Write a torch.profiler Chrome trace of the enclosed block into
    `trace_dir` (made if missing) as `kart_<pid>_<ns>.trace.json`: CPU
    activity with the block's `kart.*` spans (shapes recorded, so that each
    span's group number is in its args), and the CUDA device's kernels and
    copies where a CUDA device is available: the device idles PAD_S before
    the block and, its queued work synchronised, after it.  Raises if the
    block queued device work and the trace holds no device event
    (check_device_events).  No-op unless a directory is given or
    KART_TRACE_DIR is set."""
    trace_dir = trace_dir or os.environ.get("KART_TRACE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(trace_dir, exist_ok=True)
    launched = _port_launches()
    with profile(activities=activities, record_shapes=True) as prof:
        if cuda:
            torch.cuda.synchronize()
            time.sleep(PAD_S)
        yield
        if cuda:
            torch.cuda.synchronize()
            time.sleep(PAD_S)
    path = os.path.join(trace_dir, f"kart_{os.getpid()}_{time.time_ns()}.trace.json")
    prof.export_chrome_trace(path)
    if cuda:
        with open(path) as f:
            check_device_events(json.load(f), path, _port_launches() - launched)


def progress_line(total: int, kind: str, t0: float, file=sys.stdout) -> None:
    """The reference's progress reporter (Mapping.cpp:509)."""
    print(
        f"\r{total} {kind} reads have been processed in {int(time.time() - t0)} seconds...",
        end="",
        flush=True,
        file=file,
    )
