"""The port's mapping slice end to end on the CPU: `kart_tpu_torch.cli -cpu
-backend python` must write the same SAM bytes as kart_tpu's python backend
with batched device NW and the 13-mer funnel gated off."""

import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from kart_tpu import cli as jax_cli
from kart_tpu_torch import cli as torch_cli

from conftest import make_genome

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
from simulate_reads import simulate  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def slice_data(workdir):
    """100 kb two-chromosome genome with N runs; 200 pairs of 100 bp with
    raised indel rates so that NW runs."""
    d = workdir / "torch_slice"
    d.mkdir(exist_ok=True)
    fa = d / "g.fa"
    fa.write_text(make_genome(np.random.default_rng(1234), [60000, 40000], n_runs=3))
    from kart_tpu.index import build_index

    build_index(str(fa), str(d / "idx"), verbose=False)
    simulate(str(fa), str(d / "r1.fq"), str(d / "r2.fq"), n_reads=400, read_len=100,
             err=0.02, mut=0.01, indel_frac=0.5, seed=3)
    return d


@pytest.mark.parametrize("mode", ["pe", "se"])
def test_cpu_sam_matches_jax_python_backend(slice_data, mode, monkeypatch, capsys):
    d = slice_data
    reads = ["-f", str(d / "r1.fq")] + (["-f2", str(d / "r2.fq")] if mode == "pe" else [])
    args = ["-i", str(d / "idx"), *reads, "-backend", "python", "-silent"]
    monkeypatch.setenv("KART_BATCH_NW", "1")
    monkeypatch.setenv("KART_KMER_GATE", "0")
    assert jax_cli.main(["kart-tpu", *args, "-o", str(d / f"jax_{mode}.sam")]) == 0
    capsys.readouterr()
    assert torch_cli.main(["kart-tpu-torch", *args, "-cpu", "-o", str(d / f"torch_{mode}.sam")]) == 0
    out = capsys.readouterr().out
    want = (d / f"jax_{mode}.sam").read_bytes()
    assert (d / f"torch_{mode}.sam").read_bytes() == want
    assert want.count(b"\n") > (400 if mode == "pe" else 200)
    m = re.search(r"NW fragments on cpu = (\d+), on the host = (\d+), memo misses = (\d+)", out)
    assert m is not None, out
    assert int(m.group(1)) > 0 and int(m.group(3)) == 0, out


def test_port_maps_without_jax(slice_data, tmp_path):
    d = slice_data
    r1, r2 = tmp_path / "r1.fq", tmp_path / "r2.fq"
    for src, dst in ((d / "r1.fq", r1), (d / "r2.fq", r2)):
        dst.write_bytes(b"\n".join(src.read_bytes().split(b"\n")[:40]) + b"\n")
    code = f"""
import sys
sys.modules["jax"] = None
sys.path.insert(0, {str(REPO)!r})
from kart_tpu_torch import cli
rc = cli.main(["kart-tpu-torch", "-i", {str(d / "idx")!r}, "-f", {str(r1)!r}, "-f2", {str(r2)!r},
               "-o", {str(tmp_path / "out.sam")!r}, "-backend", "python", "-cpu", "-silent"])
assert rc == 0
assert not any(m == "jax" or m.startswith("jax.") for m, v in sys.modules.items() if v is not None)
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    recs = [ln for ln in (tmp_path / "out.sam").read_text().splitlines() if not ln.startswith("@")]
    assert len(recs) == 20


def test_port_import_leaves_jax_unloaded(tmp_path):
    """jax is installed here, and kart_tpu's package __init__ imports it;
    importing the port's modules must still load no jax and set up no JAX
    cache."""
    assert importlib.util.find_spec("jax") is not None
    code = f"""
import os, sys
sys.path.insert(0, {str(REPO)!r})
import kart_tpu_torch.cli, kart_tpu_torch.index, kart_tpu_torch.kernels
import kart_tpu_torch.pipeline.mapper
assert "kart_tpu.pipeline.candidates" in sys.modules
assert not [m for m in sys.modules if m == "jax" or m.startswith("jax.")]
assert not os.path.exists(os.path.join(os.environ["HOME"], ".cache", "kart_tpu_jax"))
"""
    env = {k: v for k, v in os.environ.items() if k != "KART_TPU_JAX_CACHE"}
    env["HOME"] = str(tmp_path)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr


def test_port_sources_do_not_import_jax():
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    files = sorted((REPO / "kart_tpu_torch").rglob("*.py"))
    assert len(files) >= 8
    assert [str(f) for f in files if pat.search(f.read_text())] == []


def test_cli_without_gpu_fails(slice_data):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    d = slice_data
    rc = torch_cli.main(["kart-tpu-torch", "-i", str(d / "idx"), "-f", str(d / "r1.fq"),
                         "-o", str(d / "nogpu.sam"), "-backend", "python"])
    assert rc != 0


@pytest.mark.parametrize(
    "extra, env, item",
    [
        (["-backend", "python", "-pacbio"], {}, "item 7"),
        (["-backend", "python", "-idx-shards", "2"], {}, "item 10"),
        (["-backend", "python"], {"KART_SA_MODE": "sampled"}, "item 8"),
        ([], {"KART_SEED_MODE": "device", "KART_SA_MODE": "sampled"}, "item 8"),
        (["-backend", "python"], {"KART_DEVICE_CLUSTER": "1"}, "item 9"),
    ],
)
def test_unported_paths_raise(slice_data, monkeypatch, extra, env, item):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    d = slice_data
    with pytest.raises(NotImplementedError, match=item):
        torch_cli.main(["kart-tpu-torch", "-i", str(d / "idx"), "-f", str(d / "r1.fq"),
                        "-o", str(d / "unported.sam"), "-cpu", *extra])
