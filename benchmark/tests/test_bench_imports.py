"""Nothing the benchmark runs imports jax or the JAX package: compared by
whole top-level name, since the port's name begins with the JAX package's."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark import harness, run

FORBIDDEN = set(run.FORBIDDEN)


def _sources():
    base = os.path.join(harness.ROOT, "benchmark")
    for d, _, files in os.walk(base):
        if "tests" in os.path.relpath(d, base).split(os.sep) or "_cache" in d:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_sources_import_neither_jax_nor_kart_tpu():
    for path in _sources():
        for n in _imports(path):
            assert n.split(".")[0] not in FORBIDDEN, (path, n)


def test_reference_imports_nothing_of_the_port():
    """The reference, its index, the yardstick and the traffic and genome
    makers import nothing of the port."""
    for path in _sources():
        rel = os.path.relpath(path, harness.ROOT)
        if rel.startswith(os.path.join("benchmark", "references")) or rel.endswith(
                ("sa_search.py", "yardstick.py", "traffic.py", "genome.py")):
            for n in _imports(path):
                assert n.split(".")[0] not in ("kart_tpu_torch",) + tuple(FORBIDDEN), (rel, n)


def test_whole_name_comparison(monkeypatch):
    base = set(run.loaded_forbidden())
    monkeypatch.setitem(sys.modules, "kart_tpu_torch_fake", object())
    assert set(run.loaded_forbidden()) == base
    monkeypatch.setitem(sys.modules, "kart_tpu.fake", object())
    assert "kart_tpu" in run.loaded_forbidden()


def test_a_run_loads_neither(tmp_path):
    """The modules a run imports, in a fresh process: no jax, no kart_tpu."""
    code = ("import sys; from benchmark import run, harness, check, control, devtrace;"
            " import benchmark.references.fast, benchmark.references.sensitive;"
            " from kart_tpu_torch.pipeline.mapper import TorchKartMapper;"
            " from kart_tpu_torch.ops.pack import pack_reads_2bit, unpack_stream;"
            " import kart_tpu_torch.index, kart_tpu_torch.kernels;"
            " print(run.loaded_forbidden())")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_refuses_without_a_card():
    """No CUDA card here: the command exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "ecoli_pe.pe150",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
