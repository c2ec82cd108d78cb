"""One run of one cell: set-up, the timed window, the traced stretch, the
check, the metrics.

The entry that the window drives is the main path's device half for one
group: the benchmark's own copy of `TorchKartMapper._dispatch_seed_async`
less its host packing and its fresh pinned buffers, so a change to the
mapper's dispatch itself does not reach it.  The group's packed arrays
(packed once in set-up by the port's own packer, `ops.pack.pack_reads_2bit`,
and held in pinned memory) are uploaded on the mapper's stream,
`_seed_resolved` seeds, resolves and packs them (the funnel, `resolve_pack`,
the stream pack), the stream is downloaded into pinned memory and an event
is recorded.  `depth` groups stay queued behind the one the host waits for,
as in the mapper.  The window cycles through the pool's groups in an order
drawn from the seed (`traffic.group_order`); the pool itself is the same
for every seed.  Each pool group has two pinned output buffers, taken in
turn, so that the last two streams of every group are still there for the
check.
"""

from __future__ import annotations

import collections
import importlib.util
import json
import os
import time
import types

import numpy as np
import torch

from benchmark import check, devtrace, genome as genome_mod, traffic as traffic_mod

ROOT = genome_mod.ROOT
TRACE_SECONDS = 2.0  # the traced stretch of a --trace 1 run, at most


def load_cell(root: str, workload: str):
    """(BENCHMARK.json, the cell, its configuration, its traffic) by name."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return bench, cell, config, traffic


def metrics_of(bench: dict, workload: str, trace: bool) -> list:
    """The cell's end-to-end metrics, or with `trace` its per-layer ones."""
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if "workloads" not in m or workload in m["workloads"]]


def reader(root: str, name: str):
    """`benchmark/metrics/<name>.py`'s read(ctx)."""
    path = os.path.join(root, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("benchmark.metrics." + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def program_index(config: dict, cache: str, codes: np.ndarray):
    """The port's index of the genome, built by the port's builder the first
    time (into a directory renamed into place when whole), then loaded."""
    from kart_tpu_torch.index import build_index, index_files_exist, load_index

    prefix = os.path.join(cache, "program_index", "genome")
    if not (index_files_exist(prefix) and os.path.exists(prefix + ".saf")):
        tmp = os.path.join(cache, "program_index.tmp")
        os.makedirs(tmp, exist_ok=True)
        fa = os.path.join(tmp, "genome.fa")
        genome_mod.write_fasta(fa, np.frombuffer(b"ACGT", np.uint8)[codes],
                               config["genome"]["name"].encode())
        build_index(fa, os.path.join(tmp, "genome"), verbose=False)
        os.remove(fa)
        if os.path.exists(os.path.dirname(prefix)):
            os.rename(os.path.dirname(prefix), tmp + ".old")
        os.rename(tmp, os.path.dirname(prefix))
    return load_index(prefix)


def make_mapper(config: dict, gidx, device):
    """The mapper as the CLI makes it, in the device-pipelined mode, after
    its prepare(); raises where it departs from what the configuration
    states."""
    os.environ["KART_SEED_MODE"] = "device"
    from kart_tpu_torch.pipeline.mapper import TorchKartMapper

    m = config["mapper"]
    mapper = TorchKartMapper(gidx, device=device, pacbio=bool(config["pacbio"]),
                             max_gaps=int(m["max_gaps"]), multi_hit=False, backend="native",
                             n_threads=int(m["threads"]), debug=False, idx_shards=0)
    mapper.prepare()
    return mapper


def departures(config: dict, mapper, l_max: int) -> list:
    """What the mapper does otherwise than the configuration states."""
    out = []
    seeder = "funnel" if mapper._get_kmer_tables() is not None else "fm_stepper"
    if seeder != config["seeder"]:
        out.append(f"seeder {seeder}, stated {config['seeder']}")
    bits = 16 if mapper._pack16(l_max) else 32
    if bits != int(config["stream_bits"]):
        out.append(f"stream {bits}-bit, stated {config['stream_bits']}")
    dt = np.dtype(mapper.gidx.index_dtype).name
    if dt != config["index_dtype"]:
        out.append(f"index {dt}, stated {config['index_dtype']}")
    if mapper.sa_mode != config["sa_mode"]:
        out.append(f"SA mode {mapper.sa_mode}, stated {config['sa_mode']}")
    if mapper.min_seed_len != int(config["min_seed_len"]):
        out.append(f"min seed length {mapper.min_seed_len}, stated {config['min_seed_len']}")
    if bool(mapper.pacbio) != bool(config["pacbio"]):
        out.append("read mode differs")
    return out


class Entry:
    """The timed entry over a pool of packed groups."""

    def __init__(self, mapper, groups, B: int, l_max: int):
        self.m = mapper
        self.dev = mapper.device
        self.cuda = self.dev.type == "cuda"
        self.groups = groups  # per group: tuple of host tensors (pinned on a card)
        self.B, self.l_max = B, l_max
        self.bufs: dict = {}  # (group, parity) -> tuple of pinned output tensors
        self.turn = [0] * len(groups)
        if self.cuda and mapper._stream is None:
            mapper._stream = torch.cuda.Stream(self.dev)
            mapper._device_sa()  # the tables' uploads precede the first group

    def dispatch(self, g: int) -> dict:
        """Queue group g; returns its pending entry."""
        m = self.m
        key = (g, self.turn[g] % 2)
        self.turn[g] += 1
        if not self.cuda:
            w, ar, ap, r = self.groups[g]
            stream = m._seed_resolved(w, ar, ap, r, self.l_max, self.B)
            self._store(key, stream)
            return dict(key=key, event=None, keep=())
        st = m._stream
        st.wait_stream(torch.cuda.current_stream(self.dev))
        with torch.cuda.stream(st):
            w, ar, ap, r = (t.to(self.dev, non_blocking=True) for t in self.groups[g])
            stream = m._seed_resolved(w, ar, ap, r, self.l_max, self.B)
            self._store(key, stream)
            event = torch.cuda.Event()
            event.record(st)
        return dict(key=key, event=event, keep=(w, ar, ap, r, stream))

    def _store(self, key, stream) -> None:
        parts = stream if isinstance(stream, tuple) else (stream,)
        if key not in self.bufs:
            self.bufs[key] = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=self.cuda)
                                   for t in parts)
        for h, t in zip(self.bufs[key], parts):
            h.copy_(t, non_blocking=self.cuda)

    @staticmethod
    def finish(entry: dict) -> None:
        if entry["event"] is not None:
            entry["event"].synchronize()

    def stream_of(self, key):
        b = self.bufs[key]
        return b if len(b) > 1 else b[0]


def run_loop(entry: Entry, order, seconds: float, depth: int, annotate: bool = False) -> dict:
    """Dispatch groups in `order` (cycled) until `seconds` have passed, with
    `depth` queued behind the one waited for, then drain: host spans of
    each dispatch, each group's time from dispatch to its stream in host
    memory, completions by buffer."""
    from torch.profiler import record_function

    enq, lat, done = [], [], collections.Counter()
    pend: collections.deque = collections.deque()
    t0 = time.perf_counter()
    t_end = t0 + seconds
    i = 0

    def wait_oldest():
        g_key, ts, e = pend.popleft()
        if annotate:
            with record_function("wait"):
                entry.finish(e)
        else:
            entry.finish(e)
        lat.append(time.perf_counter() - ts)
        done[g_key] += 1

    while True:
        ts = time.perf_counter()
        if ts >= t_end:
            break
        g = order[i % len(order)]
        i += 1
        if annotate:
            with record_function("dispatch"):
                e = entry.dispatch(g)
        else:
            e = entry.dispatch(g)
        enq.append(time.perf_counter() - ts)
        pend.append((e["key"], ts, e))
        while len(pend) > depth:
            wait_oldest()
    while pend:
        wait_oldest()
    return dict(t0=t0, t1=time.perf_counter(), enqueue_s=enq, latency_s=lat, done=done)


def checked_groups(traffic: dict, seed: int, rlens: np.ndarray, due) -> list:
    """The groups the check compares, drawn from the seed among those `due`
    (answered in the window: on a card, every group of the pool); the group
    of the pool's longest read is always one of them when it is due."""
    B = int(traffic["group_reads"])
    rng = np.random.default_rng(int(seed))
    picks = [int(g) for g in rng.permutation(sorted(due))[: int(traffic["check_groups"])]]
    longest = int(np.argmax(rlens)) // B
    if longest in due and longest not in picks:
        picks[-1] = longest
    return sorted(picks)


def trace_ctx(rec: dict) -> dict:
    """Per-layer device figures of a traced stretch."""
    dev, host = rec["device"], rec["host"]
    starts = [h["t0"] for h in host if h["cat"] == "user_annotation" and h["name"] == "dispatch"]
    t0 = min(starts)
    t1 = max(d["t1"] for d in dev)
    busy = devtrace.busy_union([(d["t0"], d["t1"]) for d in dev], t0, t1)
    ops, sets = devtrace.op_us(dev)
    return dict(
        groups=rec["info"]["groups"], window_s=(t1 - t0) / 1e6, busy_s=busy / 1e6,
        op_us=ops, set_us=sets, queued=rec["queued"],
        device_ops=devtrace.top((d["name"], d["t1"] - d["t0"]) for d in dev),
        idle_gaps=devtrace.top(devtrace.idle_gaps(dev, host, t0, t1)),
    )


def device_info(dev, peak: int, traced: dict | None) -> dict:
    if dev.type == "cuda":
        info = dict(platform="gpu", kind=torch.cuda.get_device_name(dev), count=1,
                    memory_peak_bytes=int(peak))
    else:
        info = dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=int(peak))
    if traced is not None:
        info.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
    return info


def run_loaded(bench: dict, cell: dict, config: dict, traffic: dict, *, seed: int,
               seconds: float, trace: bool, device: str, t_start: float, root: str = ROOT,
               cache_root: str = genome_mod.CACHE, log=print) -> dict:
    """One run of a cell from its loaded files -> the result line's dict.
    `t_start`: time.time() at the process's start."""
    t_start = time.perf_counter() - (time.time() - t_start)  # the window's clock
    dev = torch.device(device)
    cache = genome_mod.cache_dir(config, cache_root)
    codes = check.genome_codes(config, cache)
    B, l_max = int(traffic["group_reads"]), int(traffic["l_max"])
    n_groups, depth = int(traffic["pool_groups"]), int(traffic["depth"])
    if n_groups < depth + 2:
        raise ValueError("the pool needs at least depth + 2 groups: a buffer is reused only"
                         " once its last stream is home")
    stages = [("start", time.perf_counter())]
    reads, rlens = traffic_mod.make_pool(codes, traffic, dev)
    stages.append(("reads", time.perf_counter()))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    gidx = program_index(config, cache, codes)
    stages.append(("index", time.perf_counter()))
    mapper = make_mapper(config, gidx, dev)
    stages.append(("mapper", time.perf_counter()))
    bad = departures(config, mapper, l_max)
    if bad:
        raise RuntimeError("the program departs from the configuration: " + "; ".join(bad))
    from kart_tpu_torch.ops.pack import pack_reads_2bit

    groups, up_bytes = [], 0
    for g in range(n_groups):
        arrs = pack_reads_2bit(reads[g * B : (g + 1) * B]) + (rlens[g * B : (g + 1) * B],)
        ts = tuple(torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a) for a in arrs)
        if dev.type == "cuda":
            ts = tuple(t.pin_memory() for t in ts)
        up_bytes += sum(t.numel() * t.element_size() for t in ts)
        groups.append(ts)
    stages.append(("pack", time.perf_counter()))
    entry = Entry(mapper, groups, B, l_max)
    for _ in range(2):  # warm-up: every group into both of its buffers
        for g in range(n_groups):
            entry.finish(entry.dispatch(g))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    for b in entry.bufs.values():  # the check sees only what the window wrote
        for t in b:
            t.zero_()

    stages.append(("warm-up", time.perf_counter()))
    order = traffic_mod.group_order(traffic, seed)
    win = run_loop(entry, order, seconds, depth)
    setup_s = win["t0"] - t_start
    log("setup: " + ", ".join(f"{a} {t1 - t0:.3f} s" for (_, t0), (a, t1) in
                              zip([("process", t_start)] + stages[:-1], stages))
        + f"; {setup_s:.3f} s in all")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    traced = None
    if trace and dev.type == "cuda":
        span = min(TRACE_SECONDS, seconds)

        def step():
            r = run_loop(entry, order, span, depth, annotate=True)
            return dict(groups=sum(r["done"].values()))

        rec = devtrace.profile_session(step, lambda: entry.finish(entry.dispatch(0)),
                                       os.path.join(cache, "trace_tmp"))
        traced = trace_ctx(rec)

    # the program's state goes before the reference runs
    streams = {k: entry.stream_of(k) for k in entry.bufs}
    budget, pack16 = mapper._occ_budget(B, l_max), mapper._pack16(l_max)
    del entry, groups, mapper, gidx
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()

    # rate: every completion counts the bases of the reads its stream did not flag
    flag_of, tails = {}, []
    for k, s in sorted(streams.items()):
        ok = check.decode(s, B, budget, pack16)[0]
        g = k[0]
        flag_of[k] = (int((~ok).sum()), int(rlens[g * B : (g + 1) * B][ok].astype(np.int64).sum()))
        tail = int(np.argmax(ok[::-1])) if ok.any() else B  # the flagged reads that end the batch
        tails.append(f"{k[0]}.{k[1]}:{flag_of[k][0]}/{tail}")
    log("flagged reads / of them the batch's flagged tail, by group.buffer: " + " ".join(tails))
    attempted = failed = bases = 0
    for k, n in win["done"].items():
        attempted += n * B
        failed += n * flag_of[k][0]
        bases += n * flag_of[k][1]
    window_s = win["t1"] - win["t0"]

    t_chk = time.perf_counter()
    max_bases = max(int(traffic.get("read_len", 0)), int(config.get("window", 0)), l_max)
    index = check.reference_index(codes, cache, dev, max_bases)
    picks = checked_groups(traffic, seed, rlens, {k[0] for k in win["done"]})
    mism, works, checked, first_bad = 0, [], 0, []
    for g in picks:
        got = [streams[(g, p)] for p in (0, 1) if win["done"].get((g, p))]
        sl = slice(g * B, (g + 1) * B)
        r = check.group_check(config, index, reads[sl], rlens[sl], got, B, budget, pack16, dev)
        mism += r["mismatched"]
        checked += B - r["flagged"]
        works.append(r["work"])
        first_bad += [(g, i) for i in r["first_bad"]]
        log(f"check: group {g}: {r['flagged']} flagged, {r['occurrences']} occurrences in the"
            f" reference against a budget of {budget}")
    del index
    log(f"check: groups {picks}, {checked} reads compared, {mism} mismatched"
        f" {first_bad[:5]}, {time.perf_counter() - t_chk:.2f} s")

    work = {k: float(np.mean([w[k] for w in works])) for k in works[0]} if works else None
    ctx = types.SimpleNamespace(
        setup_s=setup_s, window_s=window_s, seeded_bases=bases, attempted=attempted,
        failed=failed, groups_done=sum(win["done"].values()), enqueue_s=win["enqueue_s"],
        latency_s=win["latency_s"], trace=traced, work=work, reads_per_group=B,
        upload_bytes_per_group=up_bytes / n_groups, config=config, traffic=traffic)
    metrics = {}
    for m in metrics_of(bench, cell["name"], trace):
        v = reader(root, m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = dict(correct=mism <= check.LIMIT_MISMATCHED and bool(works), attempted=int(attempted),
                  failed=int(failed), metrics=metrics, device=device_info(dev, peak, traced))
    if traced is not None:
        result["breakdown"] = dict(device_ops=traced["device_ops"], idle_gaps=traced["idle_gaps"])
    result["compared"] = {"mismatched_reads": {"value": int(mism),
                                               "limit": check.LIMIT_MISMATCHED}}
    return result
