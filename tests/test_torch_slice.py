"""The port's mapping slice end to end on the CPU: `kart_tpu_torch.cli -cpu
-backend python` must write the same SAM bytes as kart_tpu's python backend
with batched device NW and the 13-mer funnel gated off.  The port stands on
its own copies of the host layers: it must import and map with `kart_tpu`
and `jax` both blocked, build byte-identical index files, and generate
bench.py's genome and reads from its own generators."""

import filecmp
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


def test_port_import_leaves_jax_unloaded(slice_data, tmp_path):
    """jax and kart_tpu are installed here; with both blocked (any import of
    either raises) the port's modules must import, and the 20-read sample
    must map in the native mode and in the device-pipelined mode on the CPU,
    to the same SAM."""
    assert importlib.util.find_spec("jax") is not None
    assert importlib.util.find_spec("kart_tpu") is not None
    d = slice_data
    r1, r2 = tmp_path / "r1.fq", tmp_path / "r2.fq"
    for src, dst in ((d / "r1.fq", r1), (d / "r2.fq", r2)):
        dst.write_bytes(b"\n".join(src.read_bytes().split(b"\n")[:40]) + b"\n")
    code = f"""
import os, sys
sys.modules["kart_tpu"] = None
sys.modules["jax"] = None
sys.path.insert(0, {str(REPO)!r})
import kart_tpu_torch.cli, kart_tpu_torch.index, kart_tpu_torch.kernels
import kart_tpu_torch.pipeline.mapper, kart_tpu_torch.native.post
import kart_tpu_torch.tools.bench_gather, kart_tpu_torch.tools.simdata
from kart_tpu_torch import cli
args = ["kart-tpu-torch", "-i", {str(d / "idx")!r}, "-f", {str(r1)!r}, "-f2", {str(r2)!r}, "-silent"]
os.environ.pop("KART_SEED_MODE", None)
assert cli.main([*args, "-o", {str(tmp_path / "native.sam")!r}]) == 0
os.environ["KART_SEED_MODE"] = "device"
assert cli.main([*args, "-cpu", "-o", {str(tmp_path / "device.sam")!r}]) == 0
loaded = [m for m, v in sys.modules.items() if v is not None
          and m.split(".")[0] in ("jax", "kart_tpu", "bench")]
assert not loaded, loaded
assert not os.path.exists(os.path.join(os.environ["HOME"], ".cache", "kart_tpu_jax"))
"""
    env = {k: v for k, v in os.environ.items() if k != "KART_TPU_JAX_CACHE"}
    env["HOME"] = str(tmp_path)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    native = (tmp_path / "native.sam").read_bytes()
    assert len([ln for ln in native.splitlines() if not ln.startswith(b"@")]) == 20
    assert (tmp_path / "device.sam").read_bytes() == native


def test_port_sources_do_not_import_jax():
    """No source of the port, and not chip_smoke.py, imports jax, the JAX
    package kart_tpu (kart_tpu_torch is the port itself) or bench.py."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|kart_tpu|bench)(\.[\w.]*)?(\s|$)", re.M)
    for bad in ("import jax", "from jax.numpy import x", "  import kart_tpu", "from kart_tpu.io import y",
                "import bench", "from bench import z", "import kart_tpu.index as i"):
        assert pat.search(bad), bad
    for good in ("import kart_tpu_torch.cli", "from kart_tpu_torch import cli",
                 "from kart_tpu_torch.tools import bench_gather", "from .tools import bench_gather"):
        assert not pat.search(good), good
    files = sorted((REPO / "kart_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) >= 30
    assert [str(f) for f in files if pat.search(f.read_text())] == []


def test_port_builds_into_its_own_directory():
    """Both C++ libraries build from the port's sources into
    kart_tpu_torch/_build, never into kart_tpu's build directory."""
    from kart_tpu_torch import native
    from kart_tpu_torch.native import post

    want = str(REPO / "kart_tpu_torch" / "_build")
    assert native._BUILD_DIR == want and post._BUILD_DIR == want
    assert os.path.dirname(post.load_postlib()._name) == want
    assert (REPO / "kart_tpu_torch" / "native" / "kart_post.cpp").exists()


def test_load_postlib_raises_when_gpp_fails(monkeypatch, tmp_path):
    """A failed g++ build raises with the compiler's output; it does not
    return None for callers to slide onto another path."""
    from kart_tpu_torch.native import post

    bad = tmp_path / "native"
    bad.mkdir()
    (bad / "kart_post.cpp").write_text("this is not C++ @@@\n")
    monkeypatch.setattr(post, "_NATIVE_DIR", str(bad))
    monkeypatch.setattr(post, "_BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(post, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        post.load_postlib()
    assert "error" in str(e.value)
    from kart_tpu_torch.ops import pack

    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        pack.pack_reads_2bit(np.zeros((2, 32), np.int8))


def test_index_files_equal_kart_tpu(slice_data, tmp_path):
    """An index built by the port equals one built by kart_tpu file for
    file, so either package reads an index the other built."""
    from kart_tpu.index import build_index as jax_build
    from kart_tpu.index import load_index as jax_load
    from kart_tpu_torch.index import build_index, index_files_exist, load_index

    fa = str(slice_data / "g.fa")
    jax_build(fa, str(tmp_path / "ref"), verbose=False)
    build_index(fa, str(tmp_path / "port"), verbose=False)
    assert index_files_exist(str(tmp_path / "port"))
    exts = ("bwt", "sa", "pac", "ann", "amb", "saf")
    for ext in exts:
        a, b = tmp_path / f"ref.{ext}", tmp_path / f"port.{ext}"
        assert a.exists() and b.exists(), ext
        assert filecmp.cmp(a, b, shallow=False), ext
    assert sorted(p.name for p in tmp_path.glob("port.*")) == sorted(f"port.{e}" for e in exts)
    # each package loads the other's index to the same arrays
    g_port, g_ref = load_index(str(tmp_path / "ref")), jax_load(str(tmp_path / "port"))
    assert np.array_equal(g_port.sa_full, g_ref.sa_full)
    assert np.array_equal(g_port.ref_seq, g_ref.ref_seq)


def test_simdata_equals_bench(tmp_path, monkeypatch):
    """tools/simdata's genome and reads equal bench.py's for the same seed."""
    sys.path.insert(0, str(REPO))
    import bench

    from kart_tpu_torch.tools import simdata

    genome = simdata.make_repeat_genome(np.random.default_rng(simdata.GENOME_SEED))
    want = bench.make_repeat_genome(np.random.default_rng(7))
    assert genome.dtype == want.dtype and np.array_equal(genome, want)
    assert len(genome) == bench.GENOME_LEN == simdata.GENOME_LEN
    fa = tmp_path / "g.fa"
    simdata.write_genome_fasta(str(fa), genome)
    assert np.array_equal(simdata.read_genome_fasta(str(fa)), genome)
    n = 300
    monkeypatch.setattr(bench, "N_PAIRS", n)
    bench.simulate_reads(str(fa), str(tmp_path / "b1.fq"), str(tmp_path / "b2.fq"))
    simdata.simulate_reads(genome, str(tmp_path / "s1.fq"), str(tmp_path / "s2.fq"), n)
    for k in (1, 2):
        got = (tmp_path / f"s{k}.fq").read_bytes()
        assert got.count(b"\n") == 4 * n
        assert got == (tmp_path / f"b{k}.fq").read_bytes()


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
