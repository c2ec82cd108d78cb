"""The port's span recorder on the CPU: `utils.trace.span` off, on with
KART_TIMERS=1, and under a torch.profiler session (its Chrome trace events,
the group number in their args); the spans of one group's dispatch and
finalize nested in time; the group log's byte counters in the
device-pipelined mode; the CLI's timers line and its unchanged SAM; the
padded device_trace; the benchmark's three readers of the recorder; and
the span cost tool."""

import importlib.util
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kart_tpu_torch import cli as torch_cli
from kart_tpu_torch.tools import profile_device, span_cost
from kart_tpu_torch.utils import trace

from conftest import make_genome

REPO = Path(__file__).resolve().parent.parent
SERVED_SPANS = ("kart.read", "kart.encode", "kart.pack", "kart.upload", "kart.seed",
                "kart.decode", "kart.post")
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def span_data(workdir):
    """The 100 kb two-chromosome genome of the other port tests, indexed by
    the port, and 5,000 pairs of 150 bp: three reader chunks."""
    from kart_tpu_torch.index import build_index
    from kart_tpu_torch.tools import simulate_reads

    d = workdir / "torch_spans"
    d.mkdir(exist_ok=True)
    fa = d / "g.fa"
    fa.write_text(make_genome(np.random.default_rng(1234), [60000, 40000], n_runs=3))
    build_index(str(fa), str(d / "idx"), verbose=False)
    simulate_reads.simulate(str(fa), str(d / "r1.fq"), str(d / "r2.fq"), n_reads=10000,
                            read_len=150, err=0.015, mut=0.002, seed=21)
    return d


@pytest.fixture
def timers(monkeypatch):
    """A fresh recorder in place of the module's, off."""
    t = trace.StageTimers(enabled=False)
    monkeypatch.setattr(trace, "TIMERS", t)
    return t


def kart_events(prof, tmp_path) -> list:
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and e.get("name", "").startswith("kart.")]


def test_span_off_is_the_shared_noop(timers, monkeypatch):
    """KART_TIMERS unset at start and no profiler: the shared no-op, no clock
    read, no record function, nothing recorded."""
    assert not torch.autograd._profiler_enabled()

    def refuse(*a, **k):
        raise AssertionError("read or recorded while off")

    monkeypatch.setattr(trace.time, "perf_counter", refuse)
    monkeypatch.setattr(trace, "_RecordFunctionFast", refuse)
    for g in (None, 3):
        ctx = trace.span("kart.seed", g)
        assert ctx is trace._OFF
        with ctx:
            pass
    assert dict(timers.acc) == {} and dict(timers.n) == {}


def test_span_records_under_kart_timers(monkeypatch):
    """A recorder made with KART_TIMERS=1 set takes each span's seconds and
    count on time.perf_counter, with no profiler, and reports them on the
    StageTimers line."""
    monkeypatch.setenv("KART_TIMERS", "1")
    t = trace.StageTimers()
    monkeypatch.setattr(trace, "TIMERS", t)
    clock = iter(np.arange(1, 100) * 0.25)
    monkeypatch.setattr(trace.time, "perf_counter", lambda: float(next(clock)))
    for name, g in (("kart.seed", 0), ("kart.funnel", None), ("kart.seed", 1)):
        with trace.span(name, g):
            pass
    assert dict(t.n) == {"kart.seed": 2, "kart.funnel": 1}
    assert dict(t.acc) == {"kart.seed": 0.5, "kart.funnel": 0.25}
    buf = io.StringIO()
    t.report(n_items=1000, file=buf)
    assert buf.getvalue() == ("[kart_timers] kart.seed=0.500s (500000ns/item)"
                              "  kart.funnel=0.250s (250000ns/item)\n")


@pytest.mark.parametrize("shapes", [True, False])
def test_span_under_profiler(shapes, timers, tmp_path):
    """Under a CPU torch.profiler session the span records into the
    recorder and puts one event a span into the Chrome trace; with shapes
    recorded each is a user annotation with the group number in its args.
    Once the session ends the span is off again."""
    with profile(activities=[ProfilerActivity.CPU], record_shapes=shapes) as prof:
        for g in range(3):
            with trace.span("kart.read", g):
                torch.ones(8) + 1
        with trace.span("kart.funnel"):
            pass
    assert trace.span("kart.read", 4) is trace._OFF
    assert dict(timers.n) == {"kart.read": 3, "kart.funnel": 1}
    evs = kart_events(prof, tmp_path)
    assert sorted(e["name"] for e in evs) == ["kart.funnel"] + ["kart.read"] * 3
    if shapes:
        assert {e["cat"] for e in evs} == {"user_annotation"}
        assert sorted(e["args"].get("group", -1) for e in evs) == [-1, 0, 1, 2]


@pytest.mark.parametrize("engine,scan", [("kmer", "kart.funnel"), ("fm", "kart.fm_scan")])
def test_seed_spans_nest(engine, scan, span_data, timers, monkeypatch, tmp_path):
    """One CPU group through _dispatch_seed_async and _finalize_seed under a
    profiler: kart.pack, kart.upload, kart.seed and kart.decode carry the
    group's number, and kart.seed holds the scan's span and kart.resolve,
    one after the other, inside it in time."""
    from kart_tpu_torch.index import load_index

    for k in ("KART_SEED_MODE", "KART_KMER_GATE", "KART_SA_MODE", "KART_OCC_BUDGET"):
        monkeypatch.delenv(k, raising=False)
    mapper = profile_device.make_mapper(load_index(str(span_data / "idx")), engine, "cpu")
    rng = np.random.default_rng(5)
    B, l_max = 256, 160
    reads = rng.integers(0, 4, (B, l_max)).astype(np.int8)
    rl = np.full(B, 150, np.int32)
    reads[:, 150:] = 4
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        entry = mapper._dispatch_seed_async(reads, rl, l_max, 7)
        mapper._finalize_seed(entry, B, reads, rl, l_max)
    evs = {}
    for e in sorted(kart_events(prof, tmp_path), key=lambda e: -e["ts"]):
        evs[e["name"]] = e  # the first of each name
    assert {"kart.pack", "kart.upload", "kart.seed", scan, "kart.resolve",
            "kart.decode"} <= set(evs)
    for name in ("kart.pack", "kart.upload", "kart.seed", "kart.decode"):
        assert evs[name]["args"]["group"] == 7, name
    seed, child, res = evs["kart.seed"], evs[scan], evs["kart.resolve"]
    assert seed["ts"] <= child["ts"] < child["ts"] + child["dur"] <= res["ts"]
    assert res["ts"] + res["dur"] <= seed["ts"] + seed["dur"]
    assert timers.n["kart.seed"] == timers.n[scan] == timers.n["kart.resolve"] == 1


def test_group_log_counts_bytes(span_data, monkeypatch):
    """The device-pipelined mode on the CPU, a reader chunk a group: each
    group_log entry's upload_bytes is the packer's three arrays and the
    lengths of its (B, l_max) batch, its amb_entries the real entries of
    the packer's list of runs, and its stream_bytes the pack16 stream's
    B / 2 + H / 2 + H words."""
    from kart_tpu_torch.index import load_index
    from kart_tpu_torch.ops.pack import pack_reads_2bit_plain
    from kart_tpu_torch.pipeline.mapper import TorchKartMapper

    for k in ("KART_KMER_GATE", "KART_SA_MODE", "KART_OCC_BUDGET"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("KART_SEED_MODE", "device")
    monkeypatch.setenv("KART_DEVICE_GROUP", "1")
    mapper = TorchKartMapper(load_index(str(span_data / "idx")), device="cpu")
    mapper.prepare()
    batches = []
    dispatch = mapper._dispatch_seed_async

    def spy(reads_i8, rl, l_max, seq=None):
        batches.append((reads_i8.copy(), rl.copy(), l_max, seq))
        return dispatch(reads_i8, rl, l_max, seq)

    monkeypatch.setattr(mapper, "_dispatch_seed_async", spy)
    out = []
    mapper.map_stream(str(span_data / "r1.fq"), str(span_data / "r2.fq"), True, True,
                      out.append)
    log = mapper.group_log
    assert [b[3] for b in batches] == [0, 1, 2] and len(log) == 3
    assert [g["reads"] for g in log] == [4000, 4000, 2000]
    for (reads_i8, rl, l_max, _), g in zip(batches, log):
        B = reads_i8.shape[0]
        H = mapper._occ_budget(B, l_max)
        assert mapper._pack16(l_max)
        arrays = pack_reads_2bit_plain(reads_i8)
        assert g["upload_bytes"] == sum(a.nbytes for a in arrays) + 4 * B
        # a run a read at least: the reads are padded to l_max
        assert g["amb_entries"] == (arrays[1] < B).sum() >= g["reads"]
        assert g["stream_bytes"] == 4 * (B // 2 + H // 2 + H)


def test_cli_timers_keep_the_sam(span_data, tmp_path, monkeypatch, capsys):
    """KART_TIMERS=1 on a device-mode CLI run on the CPU: a [kart_timers]
    line on standard error naming the served path's spans, the index's
    set-up spans and its device-bytes counter, and the same SAM
    bytes as the run without it; both print the bytes uploaded and
    downloaded a read and each group's ambiguity entries."""
    d = span_data
    args = ["-i", str(d / "idx"), "-f", str(d / "r1.fq"), "-f2", str(d / "r2.fq"), "-cpu",
            "-silent"]
    monkeypatch.setenv("KART_SEED_MODE", "device")
    for k in ("KART_TIMERS", "KART_TRACE_DIR", "KART_DEVICE_GROUP"):
        monkeypatch.delenv(k, raising=False)
    assert torch_cli.main(["kart-tpu-torch", *args, "-o", str(tmp_path / "off.sam")]) == 0
    out, err = capsys.readouterr()
    assert "[kart_timers]" not in err
    assert re.search(r"on the host = 0, uploaded \d+\.\d and downloaded \d+\.\d bytes a read,"
                     r" ambiguity entries \[\d+(, \d+)*\]", out)
    env = dict(os.environ, KART_TIMERS="1", PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-m", "kart_tpu_torch.cli", *args, "-o",
                           str(tmp_path / "on.sam")], capture_output=True, text=True,
                          timeout=600, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [s for s in proc.stderr.splitlines() if s.startswith("[kart_timers] ")]
    assert len(line) == 1, proc.stderr[-3000:]
    named = {part.split("=")[0] for part in line[0].split()[1:] if "=" in part}
    assert set(SERVED_SPANS) <= named and "kart.funnel" in named, line
    assert {"kart.index.load", "kart.index.tables", "kart.index.upload",
            "index_device_bytes"} <= named, line
    assert " bytes a read" in proc.stdout
    assert (tmp_path / "on.sam").read_bytes() == (tmp_path / "off.sam").read_bytes()


def test_device_trace_pads_a_card(tmp_path, monkeypatch):
    """With a CUDA device, device_trace idles the device PAD_S before the
    block and, synchronised, after it, inside the profiler's session."""
    calls = []

    class FakeProfile:
        def __init__(self, **kw):
            calls.append(("profile", kw["record_shapes"]))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            calls.append(("closed",))
            return False

        def export_chrome_trace(self, path):
            ev = {"ph": "X", "cat": "kernel", "name": "k", "ts": 0.0, "dur": 1.0}
            Path(path).write_text(json.dumps({"traceEvents": [ev]}))

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append(("sync",)))
    monkeypatch.setattr(trace.time, "sleep", lambda s: calls.append(("sleep", s)))
    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    with trace.device_trace(str(tmp_path)):
        calls.append(("block",))
    pad = ("sleep", trace.PAD_S)
    assert trace.PAD_S == 0.5
    assert calls == [("profile", True), ("sync",), pad, ("block",), ("sync",), pad, ("closed",)]
    assert len(list(tmp_path.glob("kart_*.trace.json"))) == 1


def reader(name: str):
    path = REPO / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("name,span", [("seed_host_ms", "kart.seed"),
                                       ("funnel_host_ms", "kart.funnel"),
                                       ("resolve_host_ms", "kart.resolve")])
def test_metric_readers_read_the_recorder(name, span, timers, monkeypatch):
    """Each reader gives the mean milliseconds of its span in the module's
    recorder, None where the span recorded none, and None where the program
    has no recorder (an older checkout)."""
    read = reader(name)
    assert read(None) is None
    timers.acc["kart.other"], timers.n["kart.other"] = 1.0, 2
    assert read(None) is None
    timers.acc[span], timers.n[span] = 0.009, 4
    assert read(None) == pytest.approx(2.25)
    monkeypatch.delattr(trace, "TIMERS")
    assert read(None) is None


def test_span_cost_tool(capsys):
    """The cost tool's line: every state's microseconds a span, and the
    module's recorder left as it was."""
    before = (trace.TIMERS.enabled, dict(trace.TIMERS.n))
    assert span_cost.main(["--n", "2000", "--reps", "1"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["spans"] == 2000 and rep["torch"] == torch.__version__
    for k in ("off_us", "shared_noop_us", "recorder_us", "profiler_us", "profiler_shapes_us",
              "record_function_us"):
        assert isinstance(rep[k], float), k
    assert (trace.TIMERS.enabled, dict(trace.TIMERS.n)) == before
