"""The `celegans_pb` deployment (benchmark/configs/celegans_pb.json: PacBio
CLR reads on a C. elegans-sized genome) on the CPU at a small size: the
configuration states what the mapper chooses for a genome of WBcel235's
length, and the SensitiveMode funnel's resolved stream, through the
mapper's own `_seed_resolved` (plain versions), carries exactly the
benchmark's plain reference seeds at min seed 14, as at 13."""

import numpy as np
import pytest
import torch

from benchmark import check, genome as genome_mod, harness, sa_search, traffic as traffic_mod
from kart_tpu_torch.ops.pack import pack_reads_2bit
from kart_tpu_torch.pipeline.mapper import TorchKartMapper, compute_min_seed_length

CELL = "celegans_pb.clr6k"
WBCEL235_BP = 100_286_401  # C. elegans N2, NCBI GCF_000002985.6
SMALL_BP = 400_000
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """A seeded repeat-family genome of 400 kbp (the benchmark's recipe),
    indexed by the port, and the reference's own suffix array of its text."""
    from kart_tpu_torch.index import build_index, load_index

    d = tmp_path_factory.mktemp("celegans_pb")
    seq = genome_mod.make_repeat_genome(np.random.default_rng(7), SMALL_BP)
    genome_mod.write_fasta(str(d / "g.fa"), seq, b"g")
    build_index(str(d / "g.fa"), str(d / "idx"), verbose=False)
    codes = traffic_mod.codes_of(seq)
    text = sa_search.text_of(codes)
    sa = sa_search.suffix_array(torch.from_numpy(text)).numpy()
    return load_index(str(d / "idx")), codes, text, sa


@pytest.fixture(scope="module")
def pool(small):
    """32 long reads of 1,500-2,500 bases with clr6k's error model and
    library seed, at l_max 4096.  A third of the small genome is repeat
    families (their copy numbers are E. coli's), so the funnel flags about
    two thirds of them for the re-seed; the rest are compared."""
    traffic = harness.load_cell(harness.ROOT, CELL)[3]
    p = dict(traffic, group_reads=32, pool_groups=1, min_len=1500, max_len=2500, l_max=4096)
    reads, rlens = traffic_mod.make_pool(small[1], p, "cpu")
    return reads, rlens, int(p["l_max"])


def device_mapper(gidx, monkeypatch, msl: int, pacbio: bool = True):
    """The mapper as the benchmark makes it (device-pipelined, native
    backend), on the CPU, with the minimum seed length `msl`."""
    monkeypatch.setenv("KART_SEED_MODE", "device")
    for k in ("KART_KMER_GATE", "KART_SA_MODE"):
        monkeypatch.delenv(k, raising=False)
    m = TorchKartMapper(gidx, device="cpu", pacbio=pacbio, backend="native", n_threads=1)
    m.min_seed_len = msl
    m.prepare()
    return m


def test_config_states_what_the_mapper_chooses(small, monkeypatch):
    """WBcel235's length gives min seed 14, as the configuration states;
    with it the mapper departs from nothing the configuration states
    (funnel, 32-bit stream at clr6k's l_max, int32, full SA, PacBio)."""
    bench, cell, config, traffic = harness.load_cell(harness.ROOT, CELL)
    assert cell["config"] == "celegans_pb" and cell["traffic"] == "clr6k" and cell["chips"] == 1
    assert config["genome"]["bases"] == WBCEL235_BP
    assert compute_min_seed_length(2 * WBCEL235_BP) == config["min_seed_len"] == 14
    assert compute_min_seed_length(2 * 4_639_680) == 13  # E. coli's
    m = device_mapper(small[0], monkeypatch, compute_min_seed_length(2 * WBCEL235_BP),
                      pacbio=config["pacbio"])
    assert config["pacbio"] is True and config["stream_bits"] == 32
    assert not m._pack16(int(traffic["l_max"]))
    assert harness.departures(config, m, int(traffic["l_max"])) == []
    m.min_seed_len = 13
    assert harness.departures(config, m, int(traffic["l_max"])) == [
        "min seed length 13, stated 14"]


@pytest.mark.parametrize("msl", (13, 14))
def test_sensitive_funnel_stream_equals_the_reference(small, pool, msl, monkeypatch):
    """`_seed_resolved` (SensitiveMode funnel, resolve, 32-bit stream; plain
    versions) at min seed `msl`: every unflagged read carries exactly the
    reference's (rpos, length, text position) tuples at `msl`, in emission
    order, and differs from the reference at the other length, so a funnel
    that ignored the length above its 13-base key would fail here."""
    gidx, _, text, sa = small
    reads, rlens, l_max = pool
    B = len(rlens)
    m = device_mapper(gidx, monkeypatch, msl)
    assert m._get_kmer_tables() is not None  # the funnel seeds
    arrs = pack_reads_2bit(reads) + (rlens,)
    w, ar, ap, r = (torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)
                    for a in arrs)
    stream = m._seed_resolved(w, ar, ap, r, l_max, B)
    budget, pack16 = m._occ_budget(B, l_max), m._pack16(l_max)
    assert not pack16
    index = sa_search.SuffixIndex(text, sa, "cpu", l_max)
    config = harness.load_cell(harness.ROOT, CELL)[2]
    got = {k: check.group_check(dict(config, min_seed_len=k), index, reads, rlens, [stream], B,
                                budget, pack16, "cpu") for k in (13, 14)}
    assert got[msl]["mismatched"] == 0
    assert B - got[msl]["flagged"] >= 8 and got[msl]["occurrences"] > 10 * B
    assert got[27 - msl]["mismatched"] > 0
