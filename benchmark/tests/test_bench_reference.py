"""The plain reference against the port's CPU path at a tiny size (the
tests alone import both): its suffix array against the port's index, its
FastMode seeds against the port's host FM model, its SensitiveMode seeds
against the mapper's host SensitiveMode walk; and the control, run through
the harness."""

import numpy as np
import pytest
import torch

from benchmark import check, control, genome as genome_mod, sa_search, traffic as traffic_mod
from benchmark import yardstick
from benchmark.references import fast, sensitive
from benchmark.tests.conftest import run_tiny, tiny


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    from kart_tpu_torch.index import build_index, load_index

    d = tmp_path_factory.mktemp("ref")
    seq = genome_mod.make_repeat_genome(np.random.default_rng(5), 400_000)
    genome_mod.write_fasta(str(d / "g.fa"), seq, b"g")
    build_index(str(d / "g.fa"), str(d / "idx"), verbose=False)
    codes = traffic_mod.codes_of(seq)
    text = sa_search.text_of(codes)
    sa = sa_search.suffix_array(torch.from_numpy(text)).numpy()
    return load_index(str(d / "idx")), codes, text, sa


def _tuples(cnt, rp, sl, gp, i):
    offs = np.concatenate([[0], np.cumsum(cnt)])
    s = slice(int(offs[i]), int(offs[i + 1]))
    return list(zip(rp[s].tolist(), sl[s].tolist(), gp[s].tolist()))


def test_suffix_array_is_the_ports(small):
    gidx, _, _, sa = small
    assert sa[0] == len(gidx.ref_codes)
    assert np.array_equal(sa[1:], gidx.sa_full[1:])


def test_fast_seeds_equal_the_ports_host_model(small):
    from kart_tpu_torch.ops.fm_ref import fm_from_genome_index, identify_seed_pairs_fast

    gidx, codes, text, sa = small
    p = dict(tiny("ecoli_pe.pe150")[3], sub_rate=0.03, group_reads=100, pool_groups=2)
    reads, rl = traffic_mod.make_pool(codes, p, "cpu")
    reads[5, 40:45] = 4  # an N run inside a read
    reads[6, 0] = 4
    idx = sa_search.SuffixIndex(text, sa, "cpu", 160)
    out = fast.seeds(idx, torch.from_numpy(reads), torch.from_numpy(rl),
                     dict(min_seed_len=13, occ_thr=50))
    cnt, rp, sl, gp = (t.numpy() for t in out[:4])
    fm = fm_from_genome_index(gidx)
    assert cnt.sum() > 0
    for i in range(len(rl)):
        want = identify_seed_pairs_fast(fm, reads[i, : rl[i]].astype(np.int32), 13)
        assert _tuples(cnt, rp, sl, gp, i) == want, i


def test_sensitive_seeds_equal_the_mappers_host_walk(small):
    from kart_tpu_torch.pipeline.mapper import TorchKartMapper

    gidx, codes, text, sa = small
    p = dict(tiny("ecoli_pb.clr6k")[3], group_reads=12, pool_groups=2)
    reads, rl = traffic_mod.make_pool(codes, p, "cpu")
    reads[3, 100:104] = 4
    idx = sa_search.SuffixIndex(text, sa, "cpu", 30)
    out = sensitive.seeds(idx, torch.from_numpy(reads), torch.from_numpy(rl),
                          dict(min_seed_len=13, occ_thr=50, window=30))
    cnt, rp, sl, gp = (t.numpy() for t in out[:4])
    m = TorchKartMapper(gidx, device="cpu", pacbio=True, backend="python")
    assert cnt.sum() > 0
    for i in range(len(rl)):
        want = m._seed_sensitive_flat(reads[i, : rl[i]].astype(np.int32))
        assert _tuples(cnt, rp, sl, gp, i) == want, i


@pytest.mark.parametrize("workload", ("ecoli_pe.pe150", "ecoli_pb.clr6k"))
def test_control_is_not_correct(workload, cache_root, monkeypatch):
    """The control (the program's stream with each seed's occurrences cut to
    its first 4) run through the harness comes out not correct."""
    from kart_tpu_torch.pipeline.mapper import TorchKartMapper

    cap = tiny(workload)[2]["control"]["occ_cap"]
    monkeypatch.setattr(TorchKartMapper, "_seed_resolved",
                        control.capped(TorchKartMapper._seed_resolved, cap))
    r = run_tiny(workload, cache_root, seed=2147483021)
    assert r["correct"] is False
    assert r["compared"]["mismatched_reads"]["value"] > check.LIMIT_MISMATCHED


@pytest.mark.parametrize("pack16", (True, False))
def test_control_cut_keeps_what_is_under_its_cap(pack16):
    """cut_stream packs a stream again alike: under the cap nothing changes,
    and over it each seed's run keeps its first entries."""
    from kart_tpu_torch.ops.resolve import pack_stream_plain

    B, H = 4, 12
    cnts = torch.tensor([3, 0, -3, 2], dtype=torch.int32)  # read 2 flagged with 2 entries
    m = lambda rp, sl: rp | (sl << 16)
    meta = torch.tensor([m(0, 20)] * 3 + [m(5, 14)] * 2 + [m(1, 13), m(7, 13)] + [-1] * 5,
                        dtype=torch.int32)
    gpos = torch.where(torch.arange(H) < 7, torch.arange(H) * 10, 0).int()  # 0 past the entries
    s = pack_stream_plain(cnts, meta, gpos, pack16)
    assert torch.equal(control.cut_stream(s, B, H, pack16, 3), s)
    got = check.decode(control.cut_stream(s, B, H, pack16, 2), B, H, pack16)
    ok, tot, offs, rpos, slen, gp = got
    assert tot.tolist() == [2, 0, 2, 2] and ok.tolist() == [True, True, False, True]
    assert gp[:6].tolist() == [0, 10, 30, 40, 50, 60]
    assert rpos[:6].tolist() == [0, 0, 5, 5, 1, 7] and slen[:6].tolist() == [20, 20, 14, 14, 13, 13]


def test_distinct_sectors():
    t = torch.tensor
    assert yardstick.distinct_sectors(t([0, 10, 32]), t([1, 20, 33])) == 2
    assert yardstick.distinct_sectors(t([0]), t([65])) == 3
    assert yardstick.distinct_sectors(t([5]), t([5])) == 0
    assert yardstick.bound_ms(3.35e9, 0)[0] == pytest.approx(1.0)
