"""The port's bench (kart_tpu_torch/tools/bench.py) on the CPU: it prints
root bench.py's three lines in bench.py's order, each with bench.py's keys
(read from bench.py's source) less `relay_d2h_MBps` plus `device`; the
baseline fields are null without the reference binary and measured by
interleaved passes with one; and a failed mapping ends the run with an
error, never with a line whose value is null."""

import ast
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from kart_tpu_torch.pipeline.mapper import TorchKartMapper
from kart_tpu_torch.tools import bench, simdata
from kart_tpu_torch.tools import simulate_reads as port_sim

from conftest import make_genome

REPO = Path(__file__).resolve().parent.parent
N_PAIRS = 2000
N_PB = 3  # the SensitiveMode plain versions are slow on the CPU

torch.set_num_threads(1)


def bench_py_lines() -> dict:
    """{metric: keys} of the dict literals in root bench.py's main that carry
    "metric", in the order they appear (a metric's success and failure lines
    together)."""
    tree = ast.parse((REPO / "bench.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    lines: dict[str, set] = {}
    dicts = sorted((n for n in ast.walk(main) if isinstance(n, ast.Dict)), key=lambda n: n.lineno)
    for node in dicts:
        keys = [k.value for k in node.keys if isinstance(k, ast.Constant)]
        if "metric" in keys:
            metric = node.values[keys.index("metric")].value
            lines.setdefault(metric, set()).update(keys)
    return lines


@pytest.fixture(scope="module")
def bench_data(workdir):
    """test_torch_tools.py's assets (the 100 kb two-chromosome genome, its
    index, 2,000 pairs of 150 bp), in a directory of their own, and a few
    PacBio reads from simdata's simulator on the first chromosome."""
    from kart_tpu_torch.index import build_index

    d = workdir / "torch_bench"
    d.mkdir(exist_ok=True)
    fa = d / "g.fa"
    fa.write_text(make_genome(np.random.default_rng(1234), [60000, 40000], n_runs=3))
    build_index(str(fa), str(d / "idx"), verbose=False)
    port_sim.simulate(str(fa), str(d / "r1.fq"), str(d / "r2.fq"), n_reads=2 * N_PAIRS,
                      read_len=150, err=0.015, mut=0.002, seed=99)
    chrom1 = fa.read_bytes().split(b">")[1].split(b"\n", 1)[1].replace(b"\n", b"")
    simdata.simulate_pacbio_reads(np.frombuffer(chrom1, np.uint8), str(d / "pb.fq"), N_PB)
    return d


def bench_args(d) -> list[str]:
    return ["--cpu", "--index", str(d / "idx"), "--reads", str(d / "r1.fq"), str(d / "r2.fq"),
            "--pacbio", str(d / "pb.fq")]


@pytest.fixture
def few_passes(monkeypatch):
    for name, n in (("N_PASSES", 2), ("DEVICE_PASSES", 1), ("PB_PASSES", 1),
                    ("PB_DEVICE_PASSES", 1), ("WARM_READS", 64)):
        monkeypatch.setattr(bench, name, n)
    monkeypatch.delenv("KART_SEED_MODE", raising=False)


def test_bench_py_lines_parsed():
    lines = bench_py_lines()
    assert tuple(lines) == bench.METRICS
    assert "relay_d2h_MBps" in lines[bench.METRICS[0]]
    assert {"bases_per_sec", "device_pb_reads_per_sec"} <= lines[bench.METRICS[1]]
    assert "baseline_source" in lines[bench.METRICS[2]]


@pytest.mark.parametrize("reference", ["absent", "present"])
def test_bench_lines(reference, bench_data, few_passes, tmp_path, monkeypatch, capsys):
    """bench.py's lines and keys, every number > 0, the set-up and group
    counts on stderr; the baseline null without the reference binary, and
    with one (a stand-in that maps nothing) measured in interleaved passes."""
    ref = tmp_path / "kart"
    if reference == "present":
        ref.write_text("#!/bin/sh\nexit 0\n")
        ref.chmod(0o755)
    monkeypatch.setattr(bench, "REF_KART", str(ref))
    assert bench.main(bench_args(bench_data)) == 0
    out, err = capsys.readouterr()
    got = [json.loads(ln) for ln in out.splitlines()]
    assert [r["metric"] for r in got] == list(bench.METRICS)
    for r, (metric, keys) in zip(got, bench_py_lines().items()):
        assert set(r) == keys - {"relay_d2h_MBps"} | {"device"}, metric
        assert r["device"] == "cpu" and r["unit"] == "reads/s"
        numbers = [r[k] for k in ("value", "bases_per_sec", "device_pb_reads_per_sec") if k in r]
        assert all(x > 0 for x in numbers + r["spread"]), r
        assert r["spread"][0] <= r["value"] <= r["spread"][1]
        baseline = [r[k] for k in ("vs_baseline", "baseline_reads_per_sec") if k in r]
        if reference == "absent":
            assert baseline == [None] * len(baseline)
        else:
            assert all(x > 0 for x in baseline)
    assert ("absent" in got[2]["baseline_source"]) == (reference == "absent")
    side = json.loads(err.strip().splitlines()[-1])
    assert side["device_groups"]["reads"] == 2 * N_PAIRS
    assert side["device_pb_groups"]["reads"] == N_PB
    assert side["device_groups"]["groups"] > 0 and side["launches"] == {}  # no kernel on the CPU
    assert set(side["setup_s"]) == {"inputs_s", "native_mapper_s", "device_mapper_s"}


@pytest.mark.parametrize("fails", ["device", "pacbio"])
def test_bench_failure_raises(fails, bench_data, few_passes, monkeypatch, capsys):
    """A mapping that raises in the device passes, or in the PacBio passes,
    ends the run with the error: no line has a null value, and nothing
    follows the last good line."""
    orig = TorchKartMapper.map_stream

    def map_stream(self, *a, **k):
        if (os.environ.get("KART_SEED_MODE") == "device") if fails == "device" else self.pacbio:
            raise RuntimeError("mapping failed")
        return orig(self, *a, **k)

    monkeypatch.setattr(bench, "REF_KART", str(bench_data / "no_kart"))
    monkeypatch.setattr(TorchKartMapper, "map_stream", map_stream)
    with pytest.raises(RuntimeError, match="mapping failed"):
        bench.main(bench_args(bench_data))
    got = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["metric"] for r in got] == list(bench.METRICS[: 0 if fails == "device" else 1])
    assert all(r["value"] is not None for r in got)


def test_bench_index_needs_pacbio(bench_data):
    with pytest.raises(SystemExit, match="--pacbio"):
        bench.main(bench_args(bench_data)[:-2])
