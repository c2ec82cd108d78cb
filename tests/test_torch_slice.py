"""The port's mapping slice end to end on the CPU: `kart_tpu_torch.cli -cpu
-backend python` must write the same SAM bytes as kart_tpu's python backend
with batched device NW and the 13-mer funnel gated off.  The port stands on
its own copies of the host layers: it must import and map with `kart_tpu`
and `jax` both blocked, build byte-identical index files, and generate
bench.py's genome and reads from its own generators."""

import filecmp
import importlib.util
import json
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


DEVICE_STAGES = ("KART_DEVICE_CLUSTER", "KART_DEVICE_PAIR")


@pytest.mark.parametrize("stages", ["host", "device"])
@pytest.mark.parametrize("gate", ["fm", "funnel"])
@pytest.mark.parametrize("mode", ["pe", "se"])
def test_cpu_sam_matches_jax_python_backend(slice_data, mode, gate, stages, monkeypatch, capsys):
    """The python backend under the same environment in both packages: the
    FM stepper seeding every read (KART_KMER_GATE=0) or the funnel with its
    flagged lanes re-seeded (the default gate); candidates clustered and
    mated on the host, or on the device (KART_DEVICE_CLUSTER=1,
    KART_DEVICE_PAIR=1)."""
    d = slice_data
    reads = ["-f", str(d / "r1.fq")] + (["-f2", str(d / "r2.fq")] if mode == "pe" else [])
    args = ["-i", str(d / "idx"), *reads, "-backend", "python", "-silent"]
    monkeypatch.setenv("KART_BATCH_NW", "1")
    if gate == "fm":
        monkeypatch.setenv("KART_KMER_GATE", "0")
    else:
        monkeypatch.delenv("KART_KMER_GATE", raising=False)
    for var in DEVICE_STAGES:
        if stages == "device":
            monkeypatch.setenv(var, "1")
        else:
            monkeypatch.delenv(var, raising=False)
    tag = f"{mode}_{gate}_{stages}"
    assert jax_cli.main(["kart-tpu", *args, "-o", str(d / f"jax_{tag}.sam")]) == 0
    capsys.readouterr()
    assert torch_cli.main(["kart-tpu-torch", *args, "-cpu", "-o", str(d / f"torch_{tag}.sam")]) == 0
    out = capsys.readouterr().out
    want = (d / f"jax_{tag}.sam").read_bytes()
    assert (d / f"torch_{tag}.sam").read_bytes() == want
    assert want.count(b"\n") > (400 if mode == "pe" else 200)
    m = re.search(r"NW fragments on cpu = (\d+), on the host = (\d+), memo misses = (\d+)", out)
    assert m is not None, out
    assert int(m.group(1)) > 0 and int(m.group(3)) == 0, out


_SEED_FLAT = """
import json, os, sys
import numpy as np
sys.path.insert(0, {tests!r})
from kart_tpu.index import load_index as jax_load
from kart_tpu.ops import kmer_seed as jks
from kart_tpu.pipeline.mapper import KartMapper
from kart_tpu_torch.index import load_index
from kart_tpu_torch.pipeline import mapper as tm
from test_torch_kmer_seed import make_reads, repeat_batch

prefix = {prefix!r}
gidx, jgidx = load_index(prefix), jax_load(prefix)
reads, rlens = make_reads(gidx, 300, 150, seed=11)
rep, rep_l = repeat_batch(gidx, 40, 400)
enc = [r[:n] for r, n in zip(reads, rlens)] + [r[:n] for r, n in zip(rep, rep_l)]
enc.insert(7, np.full(30, 4, np.int32))  # an all-N read
calls = {{"jax": 0, "port": [], "port_reseeded": 0}}
jax_scan = jks.kmer_seed_scan
def jax_spy(*a, **k):
    calls["jax"] += 1
    return jax_scan(*a, **k)
jks.kmer_seed_scan = jax_spy
port_scan, port_fm = tm.kmer_seed_scan, tm.seed_scan
def port_spy(*a, **k):
    out = port_scan(*a, **k)
    calls["port"].append(int((out[:, 1] == 0).sum()))
    return out
def fm_spy(fm, reads, *a, **k):
    calls["port_reseeded"] += reads.shape[0]
    return port_fm(fm, reads, *a, **k)
tm.kmer_seed_scan, tm.seed_scan = port_spy, fm_spy
want = KartMapper(jgidx, backend="python")._seed_batch_flat(enc)
port = tm.TorchKartMapper(gidx, device="cpu", backend="python")
got = port._seed_batch_flat(enc)
tm.seed_scan = port_fm
os.environ["KART_KMER_GATE"] = "0"
fm_only = tm.TorchKartMapper(gidx, device="cpu", backend="python")._seed_batch_flat(enc)
same = [bool(a.dtype == b.dtype and np.array_equal(a, b)) for a, b in zip(got, want)]
same_fm = [bool(np.array_equal(a, b)) for a, b in zip(got, fm_only)]
print("RESULT", json.dumps(dict(same=same, same_fm=same_fm, calls=calls, n=int(got[0].sum()))))
"""


@pytest.mark.parametrize("budget", ["default", "small"])
def test_seed_batch_flat_funnel_matches_jax(workdir, budget):
    """_seed_batch_flat through the funnel: the port's flat arrays (counts,
    rpos, length, gpos) equal kart_tpu's byte for byte and the port's own FM
    stepper's, on the repeat genome's reads with an all-N read among them.
    kart_tpu pads the batch to 2,048 lanes and the port does not, so their
    slabs differ; with a hit budget of 1 and slabs of 64 rows
    (KART_HIT_BUDGET, KART_SLAB_ROWS, read where the funnel module is
    imported, hence a process of its own) lanes are flagged and re-seeded by
    the FM stepper."""
    from test_torch_kmer_seed import build_repeat_genome

    build_repeat_genome(workdir / "torch_seed_flat")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for k in ("KART_HIT_BUDGET", "KART_SLAB_ROWS", "KART_KMER_GATE", "KART_SA_MODE"):
        env.pop(k, None)
    if budget == "small":
        env.update(KART_HIT_BUDGET="1", KART_SLAB_ROWS="64")
    code = _SEED_FLAT.format(tests=str(REPO / "tests"),
                             prefix=str(workdir / "torch_seed_flat" / "idx"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, env=env, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.split("RESULT ", 1)[1])
    assert res["same"] == [True] * 4 and res["same_fm"] == [True] * 4, res
    calls = res["calls"]
    assert calls["jax"] == 1 and len(calls["port"]) == 1 and res["n"] > 1000, res
    flagged = calls["port"][0]
    assert calls["port_reseeded"] == flagged
    if budget == "small":
        assert flagged >= 20, res


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
    """No source of the port (its parallel/ package included), not
    chip_smoke.py and not the multi-host test's worker imports jax, the JAX
    package kart_tpu (kart_tpu_torch is the port itself), bench.py, the root
    __graft_entry__.py (the port has graft_entry.py) or a module of the
    repository's tools/ (the port has its own copies)."""
    root_tools = ("simulate_reads|evaluate_sam|make_huge_genome|profile_device|analyze_trace"
                  "|bench_huge|bench_scaling|scaling_curve")
    pat = re.compile(r"^\s*(import|from)\s+(jax|kart_tpu|bench|tools|__graft_entry__|" + root_tools
                     + r")(\.[\w.]*)?(\s|$)", re.M)
    for bad in ("import jax", "from jax.numpy import x", "  import kart_tpu", "from kart_tpu.io import y",
                "import bench", "from bench import z", "import kart_tpu.index as i",
                "from simulate_reads import simulate", "import evaluate_sam",
                "    from make_huge_genome import write_genome", "import profile_device",
                "from analyze_trace import analyze", "import bench_huge",
                "from tools.simulate_reads import simulate", "from tools import evaluate_sam",
                "import __graft_entry__", "    import __graft_entry__ as g",
                "from __graft_entry__ import _tiny_index", "import bench_scaling",
                "from scaling_curve import build_workload", "from tools import scaling_curve"):
        assert pat.search(bad), bad
    for good in ("import kart_tpu_torch.cli", "from kart_tpu_torch import cli",
                 "from kart_tpu_torch.tools import bench_gather", "from .tools import bench_gather",
                 "from .simulate_reads import simulate", "from . import profile_device",
                 "from kart_tpu_torch.tools import bench_huge", "from .profile_device import x",
                 "from kart_tpu_torch import graft_entry", "from ..graft_entry import _tiny_index",
                 "from .bench_scaling import CONFIGS", "from kart_tpu_torch.tools import scaling_curve",
                 "from kart_tpu_torch.tools import bench", "import kart_tpu_torch.tools.bench",
                 "from kart_tpu_torch.tools.bench import main", "from .tools import bench"):
        assert not pat.search(good), good
    files = sorted((REPO / "kart_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tests" / "torch_mh_worker.py"]
    assert len(files) >= 30
    assert {"sharded_index.py", "distributed.py", "stats_sync.py", "merge.py", "dp.py"} <= {
        f.name for f in files if f.parent.name == "parallel"}
    assert {"graft_entry.py", "bench_scaling.py", "scaling_curve.py"} <= {f.name for f in files}
    assert REPO / "kart_tpu_torch" / "tools" / "bench.py" in files
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


def test_simdata_pacbio_equals_bench(tmp_path, monkeypatch):
    """tools/simdata's PacBio reads equal bench.py's ensure_pacbio_assets
    for the same genome: the same draws in the same order."""
    sys.path.insert(0, str(REPO))
    import bench

    from kart_tpu_torch.tools import simdata

    assert (simdata.PB_N_READS, simdata.PB_MIN_LEN, simdata.PB_MAX_LEN, simdata.PB_ERR) == (
        bench.PB_N_READS, bench.PB_MIN_LEN, bench.PB_MAX_LEN, bench.PB_ERR)
    genome = np.frombuffer(b"ACGT", np.uint8)[np.random.default_rng(3).integers(0, 4, 40000)]
    fa = tmp_path / "g.fa"
    simdata.write_genome_fasta(str(fa), genome)
    n = 5
    monkeypatch.setattr(bench, "DATA", str(tmp_path))
    monkeypatch.setattr(bench, "PB_N_READS", n)
    want = Path(bench.ensure_pacbio_assets(str(fa))).read_bytes()
    simdata.simulate_pacbio_reads(genome, str(tmp_path / "pb.fq"), n)
    got = (tmp_path / "pb.fq").read_bytes()
    assert got.count(b"\n") == 4 * n and got.startswith(b"@pb0:Pos=")
    assert got == want


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
        (["-backend", "python", "-idx-shards", "2"], {}, "item 10"),
    ],
)
def test_unported_paths_raise(slice_data, monkeypatch, extra, env, item):
    """Once the refusal of ROADMAP Queue 1 `item` (-idx-shards): since that
    item is ported, the same arguments with -cpu map the slice's pairs to
    the SAM of the replicated run."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    d = slice_data
    args = ["kart-tpu-torch", "-i", str(d / "idx"), "-f", str(d / "r1.fq"), "-f2",
            str(d / "r2.fq"), "-silent", "-cpu", "-backend", "python"]
    assert torch_cli.main([*args, "-o", str(d / "unported.sam"), *extra]) == 0
    assert torch_cli.main([*args, "-o", str(d / "replicated.sam")]) == 0
    got = (d / "unported.sam").read_bytes()
    assert got == (d / "replicated.sam").read_bytes() and got.count(b"\n") > 400


@pytest.fixture(scope="module")
def flag_inputs(slice_data):
    """Inputs of the flag cases, from the slice's pairs: two libraries of 20
    pairs (reads 0-19 and 20-39), the first one gzipped, and interlaced."""
    import gzip

    d = slice_data / "flags"
    d.mkdir(exist_ok=True)
    recs = {k: (slice_data / f"r{k}.fq").read_bytes().split(b"\n") for k in (1, 2)}
    for k in (1, 2):
        for lib, lo in (("a", 0), ("b", 20)):
            (d / f"{lib}{k}.fq").write_bytes(b"\n".join(recs[k][4 * lo: 4 * (lo + 20)]) + b"\n")
        (d / f"a{k}.fq.gz").write_bytes(gzip.compress((d / f"a{k}.fq").read_bytes(), mtime=0))
    inter = [b"\n".join(recs[k][4 * i: 4 * i + 4]) for i in range(20) for k in (1, 2)]
    (d / "inter.fq").write_bytes(b"\n".join(inter) + b"\n")
    return d


# each case: its reads and flags, and whether the output is BAM
FLAG_CASES = {
    "bo": (["-f", "a1.fq", "-f2", "a2.fq"], [], True),
    "m": (["-f", "a1.fq", "-f2", "a2.fq"], ["-m"], False),
    "p": (["-f", "inter.fq"], ["-p"], False),
    "fq_gz": (["-f", "a1.fq.gz", "-f2", "a2.fq.gz"], [], False),
    "two_libraries": (["-f", "a1.fq", "b1.fq", "-f2", "a2.fq", "b2.fq"], [], False),
    "g2": (["-f", "a1.fq", "-f2", "a2.fq"], ["-g", "2"], False),
}
_FLAG_JAX: dict = {}


@pytest.mark.parametrize("shards", [0, 2])
@pytest.mark.parametrize("backend", ["native", "python"])
@pytest.mark.parametrize("case", list(FLAG_CASES))
def test_cli_flags_match_jax(flag_inputs, case, backend, shards, monkeypatch, capsys):
    """-bo, -m, -p, .fq.gz input, two libraries and -g 2: the port's -cpu
    output equals kart_tpu's in the native and python backends, also with
    -idx-shards 2 (kart_tpu's own tests hold its sharded runs to its
    replicated ones)."""
    d = flag_inputs
    reads, flags, bam = FLAG_CASES[case]
    reads = [x if x.startswith("-") else str(d / x) for x in reads]
    monkeypatch.setenv("KART_BATCH_NW", "1")
    for k in ("KART_SEED_MODE", "KART_KMER_GATE", "KART_SA_MODE", *DEVICE_STAGES):
        monkeypatch.delenv(k, raising=False)
    args = ["-i", str(d.parent / "idx"), *reads, *flags, "-backend", backend, "-silent"]
    ext = "bam" if bam else "sam"
    want = d / f"jax_{case}_{backend}.{ext}"
    if (case, backend) not in _FLAG_JAX:
        assert jax_cli.main(["kart-tpu", *args, "-bo" if bam else "-o", str(want)]) == 0
        _FLAG_JAX[case, backend] = want.read_bytes()
    got = d / f"torch_{case}_{backend}_{shards}.{ext}"
    extra = ["-idx-shards", str(shards)] if shards else []
    capsys.readouterr()
    assert torch_cli.main(["kart-tpu-torch", *args, "-cpu", *extra,
                           "-bo" if bam else "-o", str(got)]) == 0
    assert got.read_bytes() == _FLAG_JAX[case, backend]
    if not bam:
        n = 80 if case == "two_libraries" else 40
        assert len([ln for ln in got.read_text().splitlines() if not ln.startswith("@")]) >= n
    if shards:
        assert "# of device seeding groups on cpu" in capsys.readouterr().out


@pytest.fixture(scope="module")
def sample_reads(slice_data):
    """The first 20 reads of each file of the slice's pairs."""
    out = []
    for k in (1, 2):
        src, dst = slice_data / f"r{k}.fq", slice_data / f"head_r{k}.fq"
        dst.write_bytes(b"\n".join(src.read_bytes().split(b"\n")[:80]) + b"\n")
        out.append(str(dst))
    return out


SWITCH_MODES = {
    "native": ([], {}),
    "device": ([], {"KART_SEED_MODE": "device"}),
    "pacbio": (["-pacbio"], {"KART_SEED_MODE": "device"}),
    "pacbio_python": (["-pacbio", "-backend", "python"], {}),
}


@pytest.mark.parametrize("switch", DEVICE_STAGES)
@pytest.mark.parametrize("mode", list(SWITCH_MODES))
def test_device_stage_switches_leave_other_modes_alone(slice_data, sample_reads, mode, switch,
                                                        monkeypatch):
    """KART_DEVICE_CLUSTER and KART_DEVICE_PAIR are read by the python
    backend's Illumina path only, as in kart_tpu: the native and
    device-pipelined modes and -pacbio map with the same SAM with the
    switch as without it."""
    extra, env = SWITCH_MODES[mode]
    for k in ("KART_SEED_MODE", "KART_KMER_GATE", *DEVICE_STAGES):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    reads = ["-f", sample_reads[0]] + ([] if "-pacbio" in extra else ["-f2", sample_reads[1]])
    args = ["kart-tpu-torch", "-i", str(slice_data / "idx"), *reads, "-silent", "-cpu", *extra]
    off, on = slice_data / f"switch_{mode}_off.sam", slice_data / f"switch_{mode}_{switch}.sam"
    assert torch_cli.main([*args, "-o", str(off)]) == 0
    monkeypatch.setenv(switch, "1")
    assert torch_cli.main([*args, "-o", str(on)]) == 0
    recs = [ln for ln in off.read_bytes().splitlines() if not ln.startswith(b"@")]
    assert len(recs) == (20 if "-pacbio" in extra else 40)
    assert on.read_bytes() == off.read_bytes()


def test_device_stages_on_an_int64_index(slice_data, sample_reads, monkeypatch):
    """An index forced to int64 on a small genome still clusters and mates
    on the device (its positions fit int32): the same SAM as the int32
    index's; an index of 2**31 text bases or more is refused by both hooks."""
    from kart_tpu_torch.index import loader
    from kart_tpu_torch.index import load_index
    from kart_tpu_torch.pipeline.mapper import TorchKartMapper
    from kart_tpu_torch.pipeline.report import ReadState

    for k in ("KART_SEED_MODE", "KART_KMER_GATE"):
        monkeypatch.delenv(k, raising=False)
    for var in DEVICE_STAGES:
        monkeypatch.setenv(var, "1")
    args = ["kart-tpu-torch", "-i", str(slice_data / "idx"), "-f", sample_reads[0], "-f2",
            sample_reads[1], "-backend", "python", "-silent", "-cpu"]
    narrow, wide = slice_data / "stages_int32.sam", slice_data / "stages_int64.sam"
    assert torch_cli.main([*args, "-o", str(narrow)]) == 0
    monkeypatch.setattr(loader.GenomeIndex, "index_dtype", property(lambda self: np.int64))
    assert torch_cli.main([*args, "-o", str(wide)]) == 0
    assert wide.read_bytes() == narrow.read_bytes()

    mapper = TorchKartMapper(load_index(str(slice_data / "idx")), device="cpu", backend="python")
    monkeypatch.setattr(loader.GenomeIndex, "two_genome_size", property(lambda self: 2**31))
    states = [ReadState(header=b"r", seq=b"ACGT" * 25, qual=b"I" * 100, rlen=100)]
    with pytest.raises(ValueError, match=r"2\*\*31"):
        mapper._device_cluster(states, [[]])
    with pytest.raises(ValueError, match=r"2\*\*31"):
        mapper._device_pair(1500, [[], []])
