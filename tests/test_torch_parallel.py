"""The port's sharded FM index (-idx-shards) and multi-host host layer
against kart_tpu's.

The plain versions of kart_tpu_torch/parallel/sharded_index.py (the index
split into N slabs on the CPU, each lookup summed over them) are held
against kart_tpu's sharded functions inside shard_map on the forced host
devices (tests/conftest.py), at N in {1, 2, 3, 8} (3 and 8 do not divide the
index's blocks, so the last slab is padded) and in the int32 and int64
index dtypes: occ4 of a batch and of a pair, the FastMode scan, the full-SA
gather, the sampled-SA walk (whole, and cut at 8 steps), and the resolved
stream through the full SA and through the walk.  kart_tpu's int64 side runs
with jax_enable_x64 on, and off after.  Then the copied host helpers, and
the CLI: `-idx-shards 8 -cpu` in the native and python backends, full and
sampled SA (the sampled run behind a tripwire on GenomeIndex.sa_full), and
the device-pipelined mode and -pacbio with -idx-shards, each SAM equal to
kart_tpu's and to the port's replicated run.  Every comparison is exact."""

import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from kart_tpu import cli as jax_cli
from kart_tpu import parallel as jpar
from kart_tpu.index import build_index, load_index
from kart_tpu.parallel import dp as jdp
from kart_tpu.parallel import sharded_index as jsi
from kart_tpu.parallel import stats_sync as jss
from kart_tpu_torch import cli as torch_cli
from kart_tpu_torch import parallel as tpar
from kart_tpu_torch.index.loader import GenomeIndex as TorchGenomeIndex
from kart_tpu_torch.ops import fm_search as tfm
from kart_tpu_torch.parallel import sharded_index as tsi
from kart_tpu_torch.parallel import stats_sync as tss

from conftest import make_genome
from test_torch_device_slice import pacbio_data  # noqa: F401  (a fixture)
from test_torch_sampled import walk_rows
from test_torch_slice import simulate

torch.set_num_threads(1)
MIN_SEED = 13
N_SHARDS = (1, 2, 3, 8)
L_MAX, B = 64, 48
MAX_SEEDS = L_MAX // (MIN_SEED + 1) + 1
BUDGET = B  # about half the reads do not fit
OPS = ("occ4_batch", "occ4_pair", "seed_scan", "sa_gather", "sa_walk", "sa_walk_cut",
       "resolved_full", "resolved_sampled")


@pytest.fixture(scope="module")
def index(workdir):
    """A 24 kb two-chromosome genome with N runs, in a number of 128-base
    blocks that neither 3 nor 8 divides."""
    fa = workdir / "torch_parallel.fa"
    fa.write_text(make_genome(np.random.default_rng(31), [14000, 10068], n_runs=2))
    prefix = workdir / "torch_parallel_idx"
    build_index(str(fa), str(prefix), verbose=False)
    gidx = load_index(str(prefix))
    nb = np.asarray(gidx.device_arrays["occ_cp"]).shape[0]
    assert nb % 3 and nb % 8  # the last slab is padded
    return gidx


def as_dtype(gidx, dtype):
    """The index as both packages' build_sharded_fm read it, in one dtype
    (int64: the port's index_int64, the arrays widened)."""
    from kart_tpu_torch.parallel.sharded_index import index_int64

    return gidx if dtype == "int32" else index_int64(gidx)


def op_inputs(gidx, dtype):
    """Rows for occ4 (with 0, primary and its neighbours, seq_len), a pair
    of row batches, SA rows to resolve, and a batch of reads of 64 bases
    with a mismatch, a pad lane, an all-N lane and a short lane."""
    idt = np.int32 if dtype == "int32" else np.int64
    rng = np.random.default_rng(5)
    p, n = int(gidx.primary), int(gidx.seq_len)
    k = rng.integers(0, n + 1, 400)
    k[:6] = [0, 1, p - 1, p, p + 1, n]
    ka = rng.integers(0, n + 1, 200)
    kb = np.minimum(ka + rng.integers(0, 40, 200), n)
    starts = rng.integers(0, gidx.two_genome_size - L_MAX, B)
    reads = gidx.ref_codes[starts[:, None] + np.arange(L_MAX)].astype(np.int32)
    reads[:, 30] = (reads[:, 30] + 1) % 4
    rlens = np.full(B, L_MAX, np.int32)
    rlens[3], reads[3] = 0, 4
    reads[5] = 4
    rlens[7] = 11
    return dict(k=k.astype(idt), ka=ka.astype(idt), kb=kb.astype(idt),
                rows=walk_rows(gidx, 600).astype(idt), reads=reads, rlens=rlens)


_JAX: dict = {}


def jax_ops(gidx, n, dtype):
    """kart_tpu's sharded functions on an `idx` mesh of n host devices, all
    ops in one jitted shard_map; numpy results, cached."""
    key = (n, dtype)
    if key in _JAX:
        return _JAX[key]
    jax.config.update("jax_enable_x64", dtype == "int64")
    try:
        inp = op_inputs(gidx, dtype)
        sfm_host, geom = jsi.build_sharded_fm(as_dtype(gidx, dtype), n)
        mesh = Mesh(np.array(jax.devices("cpu")[:n]), ("idx",))
        sfm = jdp.place_sharded_fm(sfm_host, mesh, "idx")
        nb, ns, nsamp = geom["nb_local"], geom["ns_local"], geom["nsamp_local"]
        msl = np.int32(MIN_SEED)
        kw = dict(max_seeds=MAX_SEEDS, l_max=L_MAX)

        def local(s, k, ka, kb, rows, reads, rlens):
            res = dict(occ4_batch=jsi.sharded_occ4_batch(s, nb, "idx", k),
                       occ4_pair=jsi.sharded_occ4_pair(s, nb, "idx", ka, kb),
                       seed_scan=jsi.sharded_seed_scan(s, nb, "idx", reads, rlens, msl, **kw),
                       sa_gather=jsi.sharded_sa_gather(s.sa_full, ns, "idx", rows),
                       sa_walk=jsi.sharded_sa_walk(s, nb, nsamp, "idx", rows),
                       sa_walk_cut=jsi.sharded_sa_walk(s, nb, nsamp, "idx", rows, max_steps=8))
            for name, sf in (("resolved_full", s),
                             ("resolved_sampled", dataclasses.replace(s, sa_full=None))):
                res[name] = jsi.sharded_seed_scan_resolved(
                    sf, nb, ns, "idx", reads, rlens, msl, occ_budget=BUDGET, nsamp_local=nsamp,
                    **kw)
            return res

        fn = jax.jit(jax.shard_map(local, mesh=mesh,
                                   in_specs=(jdp.ShardedFMSpecs("idx"),) + (P(),) * 6,
                                   out_specs=P()))
        out = fn(sfm, *(jnp.asarray(inp[x]) for x in ("k", "ka", "kb", "rows", "reads",
                                                       "rlens")))
        _JAX[key] = jax.tree.map(np.asarray, out)
    finally:
        jax.config.update("jax_enable_x64", False)
    return _JAX[key]


def port_op(gidx, n, dtype, op):
    """The port's plain version of one op, n shards on the CPU."""
    inp = {k: torch.from_numpy(v) for k, v in op_inputs(gidx, dtype).items()}
    g = as_dtype(gidx, dtype)
    sfm = tsi.build_sharded_fm(g, ["cpu"] * n, "sampled" if op == "resolved_sampled" else "full")
    kw = dict(max_seeds=MAX_SEEDS, l_max=L_MAX)
    if op == "occ4_batch":
        return tsi.sharded_occ4_batch(sfm, inp["k"])
    if op == "occ4_pair":
        return tsi.sharded_occ4_pair(sfm, inp["ka"], inp["kb"])
    if op == "seed_scan":
        return tsi.sharded_seed_scan(sfm, inp["reads"], inp["rlens"], MIN_SEED, **kw)
    if op == "sa_gather":
        return tsi.sharded_sa_gather(sfm, inp["rows"])
    if op in ("sa_walk", "sa_walk_cut"):
        return tsi.sharded_sa_walk(sfm, inp["rows"], max_steps=8 if op == "sa_walk_cut" else 4096)
    return tsi.sharded_seed_scan_resolved(sfm, inp["reads"], inp["rlens"], MIN_SEED,
                                          occ_budget=BUDGET, **kw)


@pytest.mark.parametrize("dtype", ["int32", "int64"])
@pytest.mark.parametrize("n", N_SHARDS)
@pytest.mark.parametrize("op", OPS)
def test_sharded_op_matches_jax(index, op, n, dtype):
    want = jax_ops(index, n, dtype)[op]
    got = port_op(index, n, dtype, op)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.numpy().dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g.numpy(), w)
    if op == "sa_walk_cut":
        assert 0 < int((~got[1]).sum()) < len(got[1])  # rows that hit max_steps
    if op == "resolved_full":
        assert 0 < int((got[0] < 0).sum()) < B  # reads past the budget are flagged


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_sharded_ops_equal_the_replicated_index(index, dtype):
    """At 8 shards the scan, the walk and occ4 equal the replicated index's
    plain versions, and the slabs hold the index with zero padding."""
    g = as_dtype(index, dtype)
    a = dict(g.device_arrays, sa_full=g.sa_full)
    fm = tfm.FMIndexTensors.from_numpy(a, "cpu")
    sfm = tsi.build_sharded_fm(g, ["cpu"] * 8, "full")
    inp = {k: torch.from_numpy(v) for k, v in op_inputs(index, dtype).items()}
    assert torch.equal(tsi.sharded_occ4_batch(sfm, inp["k"]), tfm.occ4(fm, inp["k"]))
    kw = dict(max_seeds=MAX_SEEDS, l_max=L_MAX)
    assert torch.equal(tsi.sharded_seed_scan(sfm, inp["reads"], inp["rlens"], MIN_SEED, **kw),
                       tfm.seed_scan_plain(fm, inp["reads"], inp["rlens"], MIN_SEED, **kw))
    for steps in (4096, 8):
        for got, want in zip(tsi.sharded_sa_walk(sfm, inp["rows"], max_steps=steps),
                             tfm.sa_walk_plain(fm, inp["rows"], max_steps=steps)):
            assert torch.equal(got, want)
    occ = torch.cat([s.occ_cp for s in sfm.shards])
    assert torch.equal(occ[: fm.occ_cp.numel()], fm.occ_cp)
    assert not occ[fm.occ_cp.numel():].any()
    assert [s.occ_cp.numel() for s in sfm.shards] == [4 * sfm.nb_local] * 8


def test_sampled_build_never_reads_the_full_sa(index):
    class NoFullSA:
        device_arrays = index.device_arrays
        index_dtype = np.int32

        @property
        def sa_full(self):
            raise AssertionError("sa_full read by the sampled build")

    sfm = tsi.build_sharded_fm(NoFullSA(), ["cpu"] * 3, "sampled")
    assert not sfm.has_full_sa and sfm.ns_local == 0
    with pytest.raises(ValueError, match="without its full SA"):
        tsi.sharded_sa_gather(sfm, torch.zeros(1, dtype=torch.int32))


def test_default_shard_devices(monkeypatch):
    """All N on the CPU; on CUDA one shard a card, or with more shards than
    cards contiguous runs of shards on each card (kart_tpu refuses more
    shards than devices); no card raises."""
    assert tsi.default_shard_devices(3, "cpu") == [torch.device("cpu")] * 3
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="idx_shards=5"):
        tsi.default_shard_devices(5, "cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tsi.default_shard_devices(3, "cuda") == [torch.device("cuda", i) for i in range(3)]
    assert tsi.default_shard_devices(5, "cuda") == [torch.device("cuda", i)
                                                     for i in (0, 0, 1, 2, 3)]


# ---------------------------------------------------------------------------
# The copied host helpers
# ---------------------------------------------------------------------------


def test_ordered_chunk_writer_matches_jax():
    order = list(range(50))
    random.Random(7).shuffle(order)
    outs = []
    for mod in (jpar, tpar):
        out = []
        w = mod.OrderedChunkWriter(out.append)
        for i in order:
            w.push(i, f"chunk{i};")
        w.close()
        outs.append(out)
        w = mod.OrderedChunkWriter(lambda s: None)
        w.push(1, "x")
        with pytest.raises(RuntimeError, match="chunk 0 missing"):
            w.close()
    assert outs[0] == outs[1] == [f"chunk{i};" for i in range(50)]


def test_merge_sam_shards_matches_jax(tmp_path):
    a, b = tmp_path / "a.sam", tmp_path / "b.sam"
    a.write_text("@HD\tVN:1.0\n@SQ\tSN:c\tLN:9\nr1\t0\nr2\t0\n")
    b.write_text("@HD\tVN:1.0\n@SQ\tSN:c\tLN:9\nr3\t0\n")
    jpar.merge_sam_shards([str(a), str(b)], str(tmp_path / "j.sam"))
    tpar.merge_sam_shards([str(a), str(b)], str(tmp_path / "t.sam"))
    assert (tmp_path / "t.sam").read_bytes() == (tmp_path / "j.sam").read_bytes()
    assert (tmp_path / "t.sam").read_text() == "@HD\tVN:1.0\n@SQ\tSN:c\tLN:9\nr1\t0\nr2\t0\nr3\t0\n"


@pytest.mark.parametrize("fastq", [True, False])
def test_byte_and_record_ranges_match_jax(tmp_path, fastq):
    """fastq_record_offsets (quality lines that start with '@'),
    count_records and paired_record_ranges at 1, 2, 3, 8 and 200 shards."""
    rng = np.random.default_rng(11)
    recs = []
    for i in range(97):
        seq = "".join("ACGT"[c] for c in rng.integers(0, 4, int(rng.integers(30, 90))))
        recs.append(f"@read{i} x\n{seq}\n+\n{'@' * len(seq)}\n" if fastq else f">read{i}\n{seq}\n")
    p = tmp_path / ("r.fq" if fastq else "r.fa")
    p.write_text("".join(recs))
    from kart_tpu.parallel import distributed as jd
    from kart_tpu_torch.parallel import distributed as td

    assert td.count_records(str(p), fastq) == jd.count_records(str(p), fastq) == 97
    for n in (1, 2, 3, 8, 200):
        got = tpar.fastq_record_offsets(str(p), n, fastq=fastq)
        assert got == jpar.fastq_record_offsets(str(p), n, fastq=fastq)
        text = p.read_bytes()
        assert b"".join(text[lo:hi] for lo, hi in got) == text
        assert (tpar.paired_record_ranges(str(p), str(p), n, fastq)
                == jpar.paired_record_ranges(str(p), str(p), n, fastq))


def test_library_sharding_and_chunk_ranges_match_jax():
    f1 = [f"lib{i}_1.fq" for i in range(5)]
    f2 = [f"lib{i}_2.fq" for i in range(5)]
    for n in (1, 2, 3, 7):
        for p in range(n):
            assert tpar.shard_libraries(f1, f2, p, n) == jpar.shard_libraries(f1, f2, p, n)
        for pairs in (0, 1999, 2000, 16000, 16001):
            assert tss.chunk_aligned_ranges(pairs, n) == jss.chunk_aligned_ranges(pairs, n)
    for st in (dict(paired=999, distance=5), dict(paired=1000, distance=300000),
               dict(paired=4096, distance=123457)):
        assert tss.est_distance(st, 1500) == jss.est_distance(st, 1500)


def test_init_distributed_without_a_coordinator(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert tpar.init_distributed() == (0, 1)


def test_init_distributed_from_the_environment(tmp_path):
    """MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK, as torch reads them: a
    gloo group of one process (in a process of its own)."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    code = ("import sys; sys.path.insert(0, sys.argv[1])\n"
            "import torch.distributed as dist\n"
            "from kart_tpu_torch.parallel import init_distributed\n"
            "assert init_distributed() == (0, 1)\n"
            "assert dist.is_initialized() and dist.get_backend() == 'gloo'\n"
            "assert init_distributed() == (0, 1)\n"
            "dist.destroy_process_group()\n")
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="1",
               RANK="0")
    proc = subprocess.run([sys.executable, "-c", code, str(Path(__file__).parent.parent)],
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cli_data(workdir):
    """100 kb two-chromosome genome with N runs; 200 pairs of 100 bp, and
    kart_tpu's -idx-shards 8 SAM of them (8 host devices)."""
    d = workdir / "torch_parallel_cli"
    d.mkdir(exist_ok=True)
    fa = d / "g.fa"
    fa.write_text(make_genome(np.random.default_rng(1234), [60000, 40000], n_runs=3))
    build_index(str(fa), str(d / "idx"), verbose=False)
    simulate(str(fa), str(d / "r1.fq"), str(d / "r2.fq"), n_reads=400, read_len=100,
             err=0.02, mut=0.01, indel_frac=0.5, seed=7)
    args = ["-i", str(d / "idx"), "-f", str(d / "r1.fq"), "-f2", str(d / "r2.fq"), "-silent"]
    assert jax_cli.main(["kart-tpu", *args, "-o", str(d / "jax8.sam"), "-idx-shards", "8"]) == 0
    assert torch_cli.main(["kart-tpu-torch", *args, "-o", str(d / "replicated.sam"), "-cpu"]) == 0
    return d, args


@pytest.fixture(scope="module")
def device_slice_data(cli_data):
    """Where pacbio_data writes its reads and finds their index: cli_data's
    directory (the same genome as test_torch_device_slice's), which no other
    test file writes to."""
    return cli_data[0]


@pytest.mark.parametrize("sa_mode", ["full", "sampled"])
@pytest.mark.parametrize("backend", ["native", "python"])
def test_cli_idx_shards_8_cpu_matches_jax(cli_data, backend, sa_mode, monkeypatch, capsys):
    """-idx-shards 8 -cpu: the index in 8 slabs on the CPU.  The sampled run
    never builds the full SA (a tripwire on GenomeIndex.sa_full)."""
    d, args = cli_data
    monkeypatch.delenv("KART_SEED_MODE", raising=False)
    if sa_mode == "sampled":
        def boom(self):
            raise AssertionError("sa_full was built in the sampled sharded mode")

        monkeypatch.setattr(TorchGenomeIndex, "sa_full", property(boom))
        monkeypatch.setenv("KART_SA_MODE", "sampled")
    out = d / f"port8_{backend}_{sa_mode}.sam"
    capsys.readouterr()
    assert torch_cli.main(["kart-tpu-torch", *args, "-o", str(out), "-cpu", "-idx-shards", "8",
                           "-backend", backend]) == 0
    log = capsys.readouterr().out
    want = (d / "jax8.sam").read_bytes()
    assert out.read_bytes() == want == (d / "replicated.sam").read_bytes()
    assert want.count(b"\n") > 400
    assert "# of device seeding groups on cpu = 1, flagged lanes = 0" in log, log


def test_cli_idx_shards_key_the_budget_on_real_reads(cli_data, monkeypatch, capsys):
    """A budget of one occurrence a read flags most reads of the call, which
    are re-seeded on the host: the same SAM.  The shards come from
    KART_IDX_SHARDS here."""
    d, args = cli_data
    monkeypatch.setenv("KART_OCC_BUDGET", "1")
    monkeypatch.setenv("KART_IDX_SHARDS", "3")
    out = d / "port8_budget1.sam"
    capsys.readouterr()
    assert torch_cli.main(["kart-tpu-torch", *args, "-o", str(out), "-cpu"]) == 0
    log = capsys.readouterr().out
    assert out.read_bytes() == (d / "jax8.sam").read_bytes()
    flagged = int(log.split("flagged lanes = ")[1].split(",")[0])
    assert flagged > 100, log


@pytest.mark.parametrize("mode", ["device", "pacbio"])
def test_cli_idx_shards_keeps_the_replicated_index(cli_data, pacbio_data, mode, monkeypatch):
    """KART_SEED_MODE=device ignores -idx-shards, and -pacbio seeds through
    the replicated SensitiveMode stepper, in kart_tpu and in the port: the
    same SAM with and without the shards, and kart_tpu's."""
    d, args = cli_data
    if mode == "device":
        monkeypatch.setenv("KART_SEED_MODE", "device")
    else:
        monkeypatch.delenv("KART_SEED_MODE", raising=False)
        args = ["-i", str(pacbio_data / "idx"), "-f", str(pacbio_data / "pb.fq"), "-pacbio",
                "-silent"]
    jax_out, port_out, port_rep = (d / f"{mode}_{x}.sam" for x in ("jax8", "port8", "rep"))
    assert jax_cli.main(["kart-tpu", *args, "-o", str(jax_out), "-idx-shards", "8"]) == 0
    assert torch_cli.main(["kart-tpu-torch", *args, "-o", str(port_out), "-cpu",
                           "-idx-shards", "8"]) == 0
    assert torch_cli.main(["kart-tpu-torch", *args, "-o", str(port_rep), "-cpu"]) == 0
    want = jax_out.read_bytes()
    assert port_out.read_bytes() == want == port_rep.read_bytes()
    assert want.count(b"\n") > 40
