"""The index's set-up spans and its device-bytes counter on a small CPU
index: `kart.index.load`, `kart.index.tables` and `kart.index.upload`
recorded with the recorder off (and into a profiler's trace when one is
active), `index_device_bytes` as the distinct index tensors' bytes, the
recorder's report line, and the benchmark's two readers of them."""

import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kart_tpu_torch.utils import trace

from conftest import make_genome

REPO = Path(__file__).resolve().parent.parent
SETUP_SPANS = ("kart.index.load", "kart.index.tables", "kart.index.upload")


@pytest.fixture(scope="module")
def index_prefix(tmp_path_factory):
    from kart_tpu_torch.index import build_index

    d = tmp_path_factory.mktemp("index_setup")
    (d / "g.fa").write_text(make_genome(np.random.default_rng(99), [50000, 30000], n_runs=2))
    build_index(str(d / "g.fa"), str(d / "idx"), verbose=False)
    return str(d / "idx")


@pytest.fixture
def timers(monkeypatch):
    """A fresh recorder in place of the module's, off."""
    t = trace.StageTimers(enabled=False)
    monkeypatch.setattr(trace, "TIMERS", t)
    return t


def prepared_mapper(prefix, monkeypatch, pacbio):
    from kart_tpu_torch.index import load_index
    from kart_tpu_torch.pipeline.mapper import TorchKartMapper

    monkeypatch.setenv("KART_SEED_MODE", "device")
    for k in ("KART_KMER_GATE", "KART_SA_MODE"):
        monkeypatch.delenv(k, raising=False)
    m = TorchKartMapper(load_index(prefix), device="cpu", pacbio=pacbio, n_threads=1)
    m.prepare()
    return m


def distinct_tensor_bytes(m) -> int:
    """The bytes of the mapper's index tensors, each once by its address."""
    ts = [m._sa_dev] + list(vars(m._fm).values()) + list(vars(m._tables_dev).values())
    ts = {t.data_ptr(): t for t in ts if isinstance(t, torch.Tensor)}
    return sum(t.numel() * t.element_size() for t in ts.values())


@pytest.mark.parametrize("pacbio", [False, True])
def test_setup_spans_and_counter_with_the_recorder_off(index_prefix, timers, monkeypatch,
                                                       pacbio):
    """Loading the index and preparing the device-pipelined mapper records
    the three set-up spans though the recorder is off (the other spans stay
    off), and sets index_device_bytes to the bytes of the distinct tensors
    it holds: the full SA that the tables and the resolve share counts
    once."""
    m = prepared_mapper(index_prefix, monkeypatch, pacbio)
    assert trace.span("kart.seed") is trace._OFF
    assert dict(timers.n) == {"kart.index.load": 1, "kart.index.tables": 1,
                              "kart.index.upload": 2}  # the FM index, the tables
    assert all(timers.acc[s] > 0 for s in SETUP_SPANS)
    assert m._sa_dev.data_ptr() == m._tables_dev.sa_full.data_ptr()
    want = distinct_tensor_bytes(m)
    assert timers.counters == {"index_device_bytes": want} and m.index_device_bytes() == want
    sa = m._tables_dev.sa_full
    assert want >= sa.numel() * sa.element_size() + m._fm.occ_cp.numel() * 4
    buf = io.StringIO()
    timers.enabled = True
    timers.report(file=buf)
    line = buf.getvalue()
    assert line.startswith("[kart_timers] ") and line.endswith(f"  index_device_bytes={want}\n")
    assert all(f"{s}=" in line for s in SETUP_SPANS)


def test_setup_span_under_profiler(timers, tmp_path):
    """Under a profiler session a set-up span also puts its event into the
    trace."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.setup_span("kart.index.upload"):
            torch.ones(4) + 1
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    names = [e.get("name") for e in json.loads((tmp_path / "t.json").read_text())["traceEvents"]]
    assert names.count("kart.index.upload") == 1 and timers.n["kart.index.upload"] == 1


def reader(name: str):
    path = REPO / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_metric_readers_read_the_setup_spans_and_counter(timers, monkeypatch):
    """index_setup_s sums the three set-up spans' seconds and index_device_bytes
    reads the counter; each gives None where the program recorded none (a
    parent without them), and where it has no recorder."""
    setup_s, nbytes = reader("index_setup_s"), reader("index_device_bytes")
    timers.acc["kart.seed"], timers.n["kart.seed"] = 1.0, 3
    assert setup_s(None) is None and nbytes(None) is None
    for s, v in zip(SETUP_SPANS, (0.5, 2.0, 0.25)):
        timers.acc[s], timers.n[s] = v, 1
    trace.count("index_device_bytes", 1355400000)
    assert setup_s(None) == pytest.approx(2.75) and nbytes(None) == 1355400000
    monkeypatch.delattr(timers, "counters")  # a recorder with no counters
    assert nbytes(None) is None
    monkeypatch.delattr(trace, "TIMERS")
    assert setup_s(None) is None and nbytes(None) is None
