"""The port's tools on the CPU: the copies of kart_tpu's framework-free tools
give kart_tpu's bytes and dicts (StageTimers, progress_line, the read
simulator, the SAM evaluator, the huge-genome writer); device_trace writes a
trace that analyze_trace reads; the stage profiler runs each engine on a
small index and profiles the mapper's own stream; bench_huge prints its
lines; and every device tool refuses to run without a CUDA device unless it
is asked for the CPU."""

import io
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from kart_tpu.utils import trace as jax_trace
from kart_tpu_torch.tools import analyze_trace, bench_huge, profile_device
from kart_tpu_torch.tools import evaluate_sam as port_eval
from kart_tpu_torch.tools import make_huge_genome as port_huge
from kart_tpu_torch.tools import simulate_reads as port_sim
from kart_tpu_torch.utils import trace as port_trace

from conftest import make_genome

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
import evaluate_sam as root_eval  # noqa: E402
import make_huge_genome as root_huge  # noqa: E402
import simulate_reads as root_sim  # noqa: E402

torch.set_num_threads(1)
KART_TPU_STAGES = ("pack_host", "h2d_words", "scan_dev", "scan_resolve_dev",
                   "resolve_delta_dev", "d2h_stream", "post_native")


@pytest.fixture(scope="module")
def tools_data(workdir):
    """The 100 kb two-chromosome genome of the other port tests, indexed by
    the port, and 2,000 pairs of 150 bp: one 4,000-read group."""
    from kart_tpu_torch.index import build_index

    d = workdir / "torch_tools"
    d.mkdir(exist_ok=True)
    fa = d / "g.fa"
    fa.write_text(make_genome(np.random.default_rng(1234), [60000, 40000], n_runs=3))
    build_index(str(fa), str(d / "idx"), verbose=False)
    port_sim.simulate(str(fa), str(d / "r1.fq"), str(d / "r2.fq"), n_reads=4000, read_len=150,
                      err=0.015, mut=0.002, seed=99)
    return d


def fake_clock(monkeypatch, attr: str, step: float = 0.25):
    """time.<attr> as a clock that moves `step` further at every read."""
    t = iter(np.arange(1, 10000) * step)
    monkeypatch.setattr(f"time.{attr}", lambda: float(next(t)))


@pytest.mark.parametrize("enabled", ["1", None])
def test_stage_timers_match_kart_tpu(enabled, monkeypatch):
    """The same stages on one fake clock: the same acc, n and report line
    with KART_TIMERS=1; no-ops with it unset."""
    if enabled is None:
        monkeypatch.delenv("KART_TIMERS", raising=False)
    else:
        monkeypatch.setenv("KART_TIMERS", enabled)
    got = []
    for mod in (jax_trace, port_trace):
        fake_clock(monkeypatch, "perf_counter")
        t = mod.StageTimers()
        for name in ("seed", "post", "seed", "emit"):
            with t.stage(name):
                pass
        buf = io.StringIO()
        t.report(n_items=1000, file=buf)
        got.append((dict(t.acc), dict(t.n), buf.getvalue()))
    assert got[0] == got[1]
    if enabled:
        assert got[1][1] == {"seed": 2, "post": 1, "emit": 1}
        assert got[1][2] == ("[kart_timers] seed=0.500s (500000ns/item)  post=0.250s"
                             " (250000ns/item)  emit=0.250s (250000ns/item)\n")
    else:
        assert got[1] == ({}, {}, "")


def test_progress_line_matches_kart_tpu(monkeypatch):
    outs = []
    for mod in (jax_trace, port_trace):
        monkeypatch.setattr("time.time", lambda: 107.9)
        buf = io.StringIO()
        mod.progress_line(12000, "paired-end", 100.0, file=buf)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] == "\r12000 paired-end reads have been processed in 7 seconds..."


@pytest.mark.parametrize("how", ["arg", "env", "off"])
def test_device_trace(how, tmp_path, monkeypatch):
    """A trace dir as argument or KART_TRACE_DIR gives a Chrome trace that
    analyze reads (on the CPU: CPU events, no device lanes); neither is a
    no-op that profiles nothing."""
    monkeypatch.delenv("KART_TRACE_DIR", raising=False)
    d = tmp_path / "trace"
    if how == "env":
        monkeypatch.setenv("KART_TRACE_DIR", str(d))
    with port_trace.device_trace(str(d) if how == "arg" else None):
        assert torch.autograd.profiler._is_profiler_enabled == (how != "off")
        torch.ones(64, 64) @ torch.ones(64, 64)
    out = analyze_trace.analyze(str(d), 10, 1)
    if how == "off":
        assert not d.exists() and out is None
    else:
        assert len(list(d.glob("*.trace.json"))) == 1
        assert out["events"] > 0 and out["rows"] == [] and out["device_us"] == 0.0


@pytest.mark.parametrize("lanes", ["launches_no_device", "port_launches_no_device",
                                   "launches_and_device", "no_launches"])
def test_check_device_events(lanes, monkeypatch):
    """A trace without a device event of a block that queued device work
    (calls in the trace, or launches the port's wrappers counted) is
    refused; one with device events, or of a block that queued nothing, is
    not.  trace_spans reads the device lanes only."""
    from kart_tpu_torch import kernels

    def ev(cat, name, ts=0.0, dur=2.0):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    events = [ev("cpu_op", "aten::add_"), ev("cuda_runtime", "cudaStreamSynchronize")]
    host = 2 if lanes in ("launches_no_device", "launches_and_device") else 0
    if host:
        events += [ev("cuda_runtime", "cudaLaunchKernelExC"), ev("cuda_driver", "cuMemsetD8Async")]
    if lanes == "launches_and_device":
        events += [ev("kernel", "funnel_kernel", 5.0), ev("gpu_user_annotation", "ProfilerStep#1")]
    trace = {"traceEvents": events}
    before = port_trace._port_launches()
    monkeypatch.setattr(kernels.unpack_reads, "launches", kernels.unpack_reads.launches + 3)
    port = port_trace._port_launches() - before if lanes == "port_launches_no_device" else 0
    assert port_trace.host_launches(trace) == host
    if lanes.endswith("no_device"):
        with pytest.raises(RuntimeError, match="no device event of a block that queued device"
                                               f" work \\({host} launches, copies"
                                               f" or sets in the trace, {port} launches"):
            port_trace.check_device_events(trace, "t.json", port)
    else:
        port_trace.check_device_events(trace, "t.json", port)
        assert port_trace.trace_spans(trace) == ([(5.0, 7.0, "funnel_kernel")]
                                                 if lanes == "launches_and_device" else [])


def test_read_group_times_reps(tools_data, monkeypatch):
    """The read and the encode are each the mean of `reps` runs after an
    untimed one, with the least and most run; the file holds one group, so
    each read starts over with a reader of its own, and every reader is
    closed at the end, the group's only after the block."""
    from kart_tpu_torch.index import load_index
    from kart_tpu_torch.native import post

    monkeypatch.delenv("KART_SEED_MODE", raising=False)
    d = tools_data
    mapper = profile_device.make_mapper(load_index(str(d / "idx")), "kmer", "cpu")
    opened, calls = [], {"_read_group": 0, "_encode_group": 0}
    real_reader = post.NativeReader

    def reader(*a, **k):
        opened.append(real_reader(*a, **k))
        return opened[-1]

    monkeypatch.setattr(post, "NativeReader", reader)
    for name in calls:
        def spy(*a, _f=getattr(mapper, name), _n=name, **k):
            calls[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(mapper, name, spy)
    with profile_device.read_group(mapper, str(d / "r1.fq"), str(d / "r2.fq"), 1, 3) as got:
        chunks, reads_i8, rl, l_max, t_read, t_enc = got
        assert [h.h is None for h in opened] == [True] * 3 + [False]
        assert sum(n for n, _ in chunks) == 4000 and reads_i8.shape == (4000, 160)
    # the untimed read, then per timed read: the spent reader's empty group and a new one's
    assert calls == {"_read_group": 1 + 2 * 3, "_encode_group": 4}
    assert all(h.h is None for h in opened)
    for mean, _, (least, most) in (t_read, t_enc):
        assert 0 < least <= mean <= most


@pytest.mark.parametrize("haploid", [False, True])
@pytest.mark.parametrize("seed", [11, 99])
def test_simulate_matches_root(seed, haploid, tmp_path, workdir):
    fa = workdir / "torch_tools_sim.fa"
    fa.write_text(make_genome(np.random.default_rng(77), [30000, 20000], n_runs=2))
    kw = dict(n_reads=600, read_len=125, err=0.015, mut=0.01, seed=seed, haploid=haploid)
    port_sim.simulate(str(fa), str(tmp_path / "p1.fq"), str(tmp_path / "p2.fq"), **kw)
    root_sim.simulate(str(fa), str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq"), **kw)
    for k in (1, 2):
        port = (tmp_path / f"p{k}.fq").read_bytes()
        assert port == (tmp_path / f"r{k}.fq").read_bytes()
        assert port.count(b"\n") == 4 * 300


HAND_SAM = (
    "@HD\tVN:1.4\n@SQ\tSN:chr1\tLN:60000\n"
    "0:Pos=1001\t99\tchr1\t1010\t60\t100M\t=\t1400\t500\t" + "A" * 100 + "\t*\n"
    "0:Pos=1001\t147\tchr1\t1400\t60\t100M\t=\t1010\t-500\t" + "A" * 100 + "\t*\n"
    "1:Pos=2001\t4\t*\t0\t0\t*\t*\t0\t0\t" + "C" * 100 + "\t*\n"
    "2:Pos=3001\t0\tchr1\t9000\t37\t100M\t*\t0\t0\t" + "G" * 100 + "\t*\n"
    "3:Pos=4001\t0\tchr1\t4100\t0\t100M\t*\t0\t0\t" + "T" * 100 + "\t*\n"
    "4:Pos=5001\t0\tchr1\t5300\t0\t100M\t*\t0\t0\t" + "T" * 100 + "\t*\n"
    "6001_x\t0\tchr1\t6010\t12\t100M\t*\t0\t0\t" + "T" * 100 + "\t*\n"
)


@pytest.mark.parametrize("sam", ["port_cpu", "hand_made"])
def test_evaluate_matches_root(sam, tools_data, tmp_path, monkeypatch, capsys):
    """The same dict as root's: on the port's -cpu SAM of the device mode,
    and on a SAM with a mate pair, an unmapped read, a wrong position, two
    MAPQ-0 records (one right, one wrong) and a `POS_` name."""
    if sam == "port_cpu":
        from kart_tpu_torch import cli

        path = tmp_path / "port.sam"
        monkeypatch.setenv("KART_SEED_MODE", "device")
        d = tools_data
        assert cli.main(["kart-tpu-torch", "-i", str(d / "idx"), "-f", str(d / "r1.fq"),
                         "-f2", str(d / "r2.fq"), "-o", str(path), "-silent", "-cpu"]) == 0
    else:
        path = tmp_path / "hand.sam"
        path.write_text(HAND_SAM)
    got, want = port_eval.evaluate(str(path)), root_eval.evaluate(str(path))
    assert got == want
    if sam == "hand_made":
        assert got == dict(reads=6, mapped=5, correct=3, mapq0=2, precision=60.0, recall=50.0)
    else:
        assert got["reads"] == 2000 and got["precision"] >= 98.0, got
    err = capsys.readouterr().err
    assert err.count("# of reads=") == 2


def test_write_genome_matches_root(tmp_path, monkeypatch):
    for mod in (port_huge, root_huge):
        monkeypatch.setattr(mod, "CHROM_LENS", [12000, 7001])
    port_huge.write_genome(str(tmp_path / "port.fa"), seed=5)
    root_huge.write_genome(str(tmp_path / "root.fa"), seed=5)
    data = (tmp_path / "port.fa").read_bytes()
    assert data == (tmp_path / "root.fa").read_bytes()
    assert data.startswith(b">chr1 huge synthetic 1\n") and b">chr2 huge synthetic 2\n" in data


def profile_args(d, engine):
    return ["--cpu", "--group", "1", "--reps", "1", "--engine", engine,
            "--index", str(d / "idx"), "--reads", str(d / "r1.fq"), str(d / "r2.fq")]


@pytest.mark.parametrize("engine", ["kmer", "fm", "fm_sampled"])
def test_profile_device_cpu(engine, tools_data, capsys, monkeypatch):
    """--cpu --group 1 on the small index: kart_tpu's stage names and the
    port's additions, host timing throughout, copies null, and the engine
    asked for; the environment is as it was after."""
    for k in ("KART_SEED_MODE", "KART_KMER_GATE", "KART_SA_MODE"):
        monkeypatch.delenv(k, raising=False)
    assert profile_device.main(profile_args(tools_data, engine)) == 0
    rep = json.loads(capsys.readouterr().out)
    assert set(KART_TPU_STAGES) <= set(rep["stages_s"])
    assert set(rep["stages_s"]) == set(rep["per_read_us"]) == set(rep["timing"])
    assert set(rep["stages_s"]) - set(KART_TPU_STAGES) == {
        "read_host", "encode_host", "pin_host", "finalize_host", "reseed_batch",
        "group_serial"}
    for k, v in rep["stages_s"].items():
        if k in ("pin_host", "h2d_words", "d2h_stream"):
            assert v is None and rep["timing"][k] is None, k
        else:
            assert rep["timing"][k] == "host", k
            assert k == "resolve_delta_dev" or v >= 0, k
    der = rep["derived"]
    assert der["engine"] == {"kmer": "kmer", "fm": "fm/full", "fm_sampled": "fm/sampled"}[engine]
    assert (der["B"], der["l_max"], der["device"]) == (4000, 160, "cpu")
    assert der["mapped_reads"] > 3900
    for k in ("KART_SEED_MODE", "KART_KMER_GATE", "KART_SA_MODE"):
        assert k not in os.environ


@pytest.mark.parametrize("engine,budget", [("kmer", None), ("fm", None), ("fm_sampled", None),
                                           ("kmer", "1")])
def test_profile_stream_is_the_mappers(engine, budget, tools_data, monkeypatch):
    """The profiled stream equals a fresh mapper's own dispatch and finalize
    of the same group, read and encoded as kart_tpu's tool reads it (python
    reader, _encode); with KART_OCC_BUDGET=1 lanes overrun the stream and the
    re-seed batch runs."""
    from kart_tpu_torch.index import load_index
    from kart_tpu_torch.io.fastq import ReadStream, next_chunk
    from kart_tpu_torch.ops.pack import unpack_stream
    from kart_tpu_torch.ops.resolve import decode_resolved_counts

    for k in ("KART_SEED_MODE", "KART_KMER_GATE", "KART_SA_MODE", "KART_OCC_BUDGET"):
        monkeypatch.delenv(k, raising=False)
    if budget:
        monkeypatch.setenv("KART_OCC_BUDGET", budget)
    d = tools_data
    gidx = load_index(str(d / "idx"))
    mapper = profile_device.make_mapper(gidx, engine, "cpu")
    rep, stream = profile_device.profile(mapper, str(d / "r1.fq"), str(d / "r2.fq"), group=1,
                                         reps=1)

    B, l_max = 4000, 160
    reads = np.full((B, l_max), 4, np.int8)
    rl = np.zeros(B, np.int32)
    s1, s2 = ReadStream(str(d / "r1.fq"), True), ReadStream(str(d / "r2.fq"), True)
    for row, r in enumerate(next_chunk(s1, s2, True, False)[:B]):
        enc = mapper._encode(r.seq)
        reads[row, : len(enc)] = enc
        rl[row] = len(enc)
    s1.close()
    s2.close()
    own = profile_device.make_mapper(gidx, engine, "cpu")
    entry = own._dispatch_seed_async(reads, rl, l_max)
    assert np.array_equal(entry["host"].numpy(), stream)
    tot, offs, rpos, slen, gpos, overrides = own._finalize_seed(entry, B, reads, rl, l_max)
    cnts, meta, gp = unpack_stream(stream, B, own._occ_budget(B, l_max), own._pack16(l_max))
    ok, tot2, offs2 = decode_resolved_counts(cnts)
    assert np.array_equal(tot, tot2) and np.array_equal(offs, offs2)
    assert np.array_equal(rpos, meta & 0xFFFF) and np.array_equal(gpos, gp)
    n_bad = int((~ok).sum())
    assert rep["derived"]["flagged_lanes"] == n_bad == len(overrides)
    if budget:
        assert n_bad > 0 and rep["stages_s"]["reseed_batch"] > 0
        assert rep["derived"]["reseeded_device"] + rep["derived"]["reseeded_host"] == n_bad
    else:
        assert n_bad == 0 and rep["stages_s"]["reseed_batch"] == 0.0


def test_analyze_synthetic_trace(tmp_path, capsys):
    """Device lanes only (kernels, copies, sets) are summed and ranked;
    host events are not; busy time is the union of overlapping spans."""
    def ev(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": ts, "dur": dur}

    events = [ev("kernel", "funnel_kernel", t, 10.0) for t in (0, 100, 200)]
    events += [ev("kernel", "emit_kernel", 20, 50.0), ev("kernel", "emit_kernel", 25, 5.0)]
    events += [ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", t, 4.0) for t in (300, 310)]
    events += [ev("gpu_memset", "Memset (Device)", 400, 1.0)]
    events += [ev("cpu_op", "aten::empty", 0, 900.0), ev("cuda_runtime", "cudaLaunchKernel", 5, 3.0),
               {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1}]
    (tmp_path / "x.trace.json").write_text(json.dumps({"traceEvents": events}))
    out = analyze_trace.analyze(str(tmp_path), 3, 3)
    assert out["rows"] == [("emit_kernel", 2, 55.0, 55.0 / 3), ("funnel_kernel", 3, 30.0, 10.0),
                           ("Memcpy HtoD (Pinned -> Device)", 2, 8.0, 8.0 / 3)]
    assert out["device_us"] == 94.0 and out["busy_us"] == pytest.approx(89.0)
    assert out["events"] == 10
    text = capsys.readouterr().out
    assert "device total 94.0 us over 3 reps" in text and "aten::empty" not in text


def test_bench_huge_assets_missing(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(bench_huge, "HUGE", str(tmp_path))
    assert bench_huge.run(["--cpu"]) == 1
    assert "huge assets missing" in json.loads(capsys.readouterr().out)["error"]


def test_bench_huge_cpu_int64(tmp_path, monkeypatch, capsys):
    """On a small index forced to int64, both modes print their metric line
    with -cpu's device; the reads are simulated where missing."""
    from kart_tpu_torch.index import build_index, loader

    fa = tmp_path / "huge.fa"
    fa.write_text(make_genome(np.random.default_rng(31), [40000, 30000], n_runs=2))
    build_index(str(fa), str(tmp_path / "idx"), verbose=False)
    monkeypatch.setattr(loader.GenomeIndex, "index_dtype", property(lambda self: np.int64))
    monkeypatch.setattr(bench_huge, "HUGE", str(tmp_path))
    for k in ("KART_SEED_MODE", "KART_SA_MODE"):
        monkeypatch.delenv(k, raising=False)
    assert bench_huge.run(["--cpu", "--reads", "400", "--passes", "1"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["metric"] for r in lines] == ["huge_genome_reads_per_sec_native_fm",
                                            "huge_genome_reads_per_sec_device_i64"]
    assert all(r["value"] > 0 and r["device"] == "cpu" and "error" not in r for r in lines)
    assert (tmp_path / "bench_h1.fq").read_bytes().count(b"\n") == 4 * 200


@pytest.mark.parametrize("tool", ["profile_device", "analyze_trace", "bench_huge"])
def test_tools_refuse_without_cuda(tool, tools_data, monkeypatch):
    """Without --cpu and without a CUDA device each device tool exits
    non-zero before it measures anything; there is no quiet CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench_huge, "HUGE", str(tools_data))
    main = {"profile_device": profile_device.main, "analyze_trace": analyze_trace.main,
            "bench_huge": bench_huge.run}[tool]
    d = tools_data
    args = {"profile_device": profile_args(d, "kmer")[1:],
            "analyze_trace": ["--group", "1", "--index", str(d / "idx"),
                              "--reads", str(d / "r1.fq"), str(d / "r2.fq")],
            "bench_huge": []}[tool]
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(args)
