"""The sampled SA mode and the int64 index end to end on the CPU:
`kart_tpu_torch.cli -cpu` with KART_SA_MODE=sampled, in the native,
device-pipelined (KART_SEED_MODE=device) and `-backend python` modes, for
paired-end Illumina reads and `-pacbio` reads, must write kart_tpu's SAM
bytes for the same mode and the port's own KART_SA_MODE=full SAM; again
with the index's dtype forced to int64 (both packages' GenomeIndex report
int64, as tests/test_golden_sam.py forces the int64 shape).  The sampled
runs are frugal: the full SA and the funnel's tables are never built."""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from kart_tpu import cli as jax_cli
from kart_tpu.index import loader as jax_loader
from kart_tpu_torch import cli as torch_cli
from kart_tpu_torch import index as torch_index
from kart_tpu_torch.index import loader as torch_loader
from kart_tpu_torch.pipeline import mapper as torch_mapper

from conftest import make_genome

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
from simulate_reads import simulate  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sampled_data(workdir):
    """A 70 kb two-chromosome genome with N runs; 150 pairs of 100 bp with
    raised indel rates, and 16 PacBio-like reads of 300-900 bases (the
    port's simdata error model, every fourth from the reverse strand)."""
    from kart_tpu.index import build_index
    from kart_tpu.index.format import parse_fasta
    from kart_tpu_torch.tools.simdata import noisy_copy

    d = workdir / "torch_sampled_slice"
    d.mkdir(exist_ok=True)
    fa = d / "g.fa"
    fa.write_text(make_genome(np.random.default_rng(4321), [40000, 30000], n_runs=3))
    build_index(str(fa), str(d / "idx"), verbose=False)
    simulate(str(fa), str(d / "r1.fq"), str(d / "r2.fq"), n_reads=300, read_len=100,
             err=0.02, mut=0.01, indel_frac=0.5, seed=8)
    seqs = [np.frombuffer(s.seq, np.uint8) for s in parse_fasta(str(fa))]
    rng = np.random.default_rng(12)
    comp = bytes.maketrans(b"ACGTN", b"TGCAN")
    with open(d / "pb.fq", "wb") as f:
        for i in range(16):
            g = seqs[i % 2]
            rl = int(rng.integers(300, 900))
            p = int(rng.integers(0, len(g) - 2 * rl))
            seq = noisy_copy(rng, g[p : p + int(rl * 1.3)], rl, err=0.12)
            if i % 4 == 0:
                seq = seq.translate(comp)[::-1]
            f.write(b"@pb%d:Pos=%d\n%s\n+\n%s\n" % (i, p + 1, seq, b"I" * len(seq)))
    return d


@pytest.fixture
def force_int64(monkeypatch):
    """Both packages' GenomeIndex report an int64 index dtype; kart_tpu's
    loader turns jax_enable_x64 on for it, which is turned off after."""
    for cls in (jax_loader.GenomeIndex, torch_loader.GenomeIndex):
        monkeypatch.setattr(cls, "index_dtype", property(lambda self: np.int64))
    yield
    jax.config.update("jax_enable_x64", False)


def run_port(args, out, monkeypatch):
    """The port's CLI with -cpu; returns the GenomeIndex it loaded."""
    loaded = []

    def spy(prefix):
        loaded.append(load(prefix))
        return loaded[-1]

    load = torch_index.load_index
    monkeypatch.setattr(torch_index, "load_index", spy)
    assert torch_cli.main(["kart-tpu-torch", *args, "-cpu", "-o", str(out)]) == 0
    monkeypatch.setattr(torch_index, "load_index", load)
    return loaded[0]


MODES = {"native": ({}, []), "device": ({"KART_SEED_MODE": "device"}, []),
         "python": ({}, ["-backend", "python"])}


@pytest.mark.parametrize("dtype", ["int32", "int64"])
@pytest.mark.parametrize("data", ["pe", "pacbio"])
@pytest.mark.parametrize("mode", list(MODES))
def test_sampled_sam_matches(sampled_data, mode, data, dtype, monkeypatch, request, capsys):
    d = sampled_data
    if dtype == "int64":
        request.getfixturevalue("force_int64")
    env, extra = MODES[mode]
    for k in ("KART_SEED_MODE", "KART_KMER_GATE", "KART_SA_MODE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    reads = (["-f", str(d / "r1.fq"), "-f2", str(d / "r2.fq")] if data == "pe"
             else ["-f", str(d / "pb.fq"), "-pacbio"])
    args = ["-i", str(d / "idx"), *reads, "-silent", *extra]
    tag = f"{mode}_{data}_{dtype}"

    monkeypatch.setenv("KART_SA_MODE", "full")
    full_gidx = run_port(args, d / f"port_full_{tag}.sam", monkeypatch)
    assert full_gidx.index_dtype is (np.int32 if dtype == "int32" else np.int64)

    monkeypatch.setenv("KART_SA_MODE", "sampled")
    assert jax_cli.main(["kart-tpu", *args, "-o", str(d / f"jax_{tag}.sam")]) == 0

    def no_tables(gidx, *a, **k):
        raise AssertionError("the sampled SA mode built the funnel's tables")

    monkeypatch.setattr(torch_mapper, "build_tables", no_tables)
    capsys.readouterr()
    gidx = run_port(args, d / f"port_{tag}.sam", monkeypatch)
    out = capsys.readouterr().out
    assert "sa_full" not in gidx.__dict__, "the sampled SA mode built the full SA"

    want = (d / f"jax_{tag}.sam").read_bytes()
    recs = [ln for ln in want.splitlines() if not ln.startswith(b"@")]
    assert len(recs) == (300 if data == "pe" else 16)
    assert sum(1 for r in recs if not int(r.split(b"\t")[1]) & 4) >= 0.8 * len(recs)
    assert (d / f"port_{tag}.sam").read_bytes() == want
    assert (d / f"port_full_{tag}.sam").read_bytes() == want
    if mode == "device":
        assert "device seeding groups on cpu = 1," in out, out
