"""The port's read packing, read unpack and stream packing against
kart_tpu's (`kart_tpu/ops/pack.py`), exactly, with dtypes asserted."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kart_tpu.ops import pack as jpack
from kart_tpu_torch.ops import pack as tpack

torch.set_num_threads(1)


def random_codes(rng, B, L, n_frac=0.01):
    reads = rng.integers(0, 4, (B, L)).astype(np.int8)
    reads[rng.random((B, L)) < n_frac] = 4
    return reads


def layout_codes(B, L, layout):
    """Random codes with ambiguous bases: a random share (a float), or a
    named layout of runs over codes without any."""
    reads = random_codes(np.random.default_rng(B), B, L, layout if isinstance(layout, float) else 0)
    if layout == "row_end":  # reads padded to l_max, one row exactly full
        for i in range(B - 1):
            reads[i, L - 1 - 3 * i :] = 4
    elif layout == "all_pad_row":
        reads[1] = reads[3] = 4
    elif layout == "word_edges":  # across a 16-base word, a 32-bit mask word, several words
        for a, b in ((14, 18), (30, 34), (47, 49), (60, 101), (127, 129), (144, 160)):
            reads[0, a:b] = 4
        reads[1, 15:17] = reads[1, 31:33] = reads[1, 63:65] = 4
        reads[2, 16:48] = 4
    elif layout == "isolated":
        reads[:, ::7] = 4
        reads[:, -1] = 4
    elif layout == "across_rows":  # each run ends a row, the next starts the next row
        reads[0, 50:] = reads[1, :20] = reads[1, 60:] = reads[2, :] = reads[3, :5] = 4
    elif layout == "whole_row_max":  # a read of l_max 32,768 all pad: one run of 2**15
        reads[1] = 4
        reads[0, 100:] = 4
        reads[2, rng_positions(L)] = 4
    elif layout == "split_runs":  # past 2**15 bases a run is split; starts up to 2**16 - 1
        reads[0] = 4
        reads[1, 1:] = 4
    return reads


def rng_positions(L):
    return np.random.default_rng(L).integers(0, L, 300)


def expand_runs(amb_r, amb_p, B):
    """The (row, position) pairs a run list covers, in list order; pads
    (row B) dropped."""
    keep = amb_r < B
    r, p = amb_r[keep].astype(np.int64), amb_p[keep].astype(np.int64)
    start, n = p & 0xFFFF, ((p >> 16) & 0x7FFF) + 1
    k = np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
    return np.repeat(r, n), np.repeat(start, n) + k


def assert_runs_of(amb_r, amb_p, point_r, point_p, B):
    """The run list covers exactly kart_tpu's point list, entry for entry,
    its runs maximal (a run that does not fill 2**15 bases is not followed
    by an adjacent one in its row), its pads row B as the points' are, and
    its length the capacity bucket of its runs."""
    assert amb_r.dtype == amb_p.dtype == point_r.dtype == np.int32
    rows, pos = expand_runs(amb_r, amb_p, B)
    real = point_r < B
    np.testing.assert_array_equal(rows, point_r[real])
    np.testing.assert_array_equal(pos, point_p[real])
    n = int((amb_r < B).sum())
    assert len(amb_r) == tpack._amb_bucket(n) and (amb_r[n:] == B).all() and (amb_p[n:] == 0).all()
    r, p = amb_r[:n], amb_p[:n]
    start, length = p & 0xFFFF, ((p >> 16) & 0x7FFF) + 1
    same_row = r[1:] == r[:-1]
    adjacent = start[1:] == start[:-1] + length[:-1]
    assert not (same_row & adjacent & (length[:-1] < tpack.AMB_RUN_MAX)).any()


PACK_CASES = [(7, 64, 0.0), (33, 150, 0.01), (64, 160, 0.2), (6, 150, "row_end"),
              (5, 160, "all_pad_row"), (3, 160, "word_edges"), (8, 100, "isolated"),
              (4, 64, "across_rows"), (3, 32768, "whole_row_max"), (2, 65536, "split_runs")]


@pytest.mark.parametrize("B, L, n_frac", PACK_CASES)
def test_pack_reads_2bit_matches(B, L, n_frac):
    """The C++ packer's words are kart_tpu's; its runs expand to kart_tpu's
    list of ambiguous positions."""
    reads = layout_codes(B, L, n_frac)
    want = jpack.pack_reads_2bit(reads)
    got = tpack.pack_reads_2bit(reads)
    assert got[0].dtype == want[0].dtype
    np.testing.assert_array_equal(got[0], want[0])
    assert_runs_of(*got[1:], *want[1:], B)
    if n_frac in ("row_end", "all_pad_row", "whole_row_max", "split_runs"):
        assert (got[1] < B).sum() < (want[1] < B).sum()


@pytest.mark.parametrize("B, L, n_frac", PACK_CASES)
def test_pack_reads_2bit_plain_matches(B, L, n_frac):
    """The numpy packer is the plain version of the C++ packer: the same
    arrays, also for a batch that is not contiguous, whose runs expand to
    kart_tpu's list."""
    reads = layout_codes(B, L, n_frac)
    want = tpack.pack_reads_2bit(reads)
    wide = np.full((B, L + 5), 1, np.int8)
    wide[:, :L] = reads
    for got in (tpack.pack_reads_2bit_plain(reads), tpack.pack_reads_2bit(wide[:, :L])):
        for w, g in zip(want, got):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    jw, jr, jp = jpack.pack_reads_2bit(reads)
    np.testing.assert_array_equal(want[0], jw)
    assert_runs_of(want[1], want[2], jr, jp, B)


def test_pack_refuses_l_max_past_run_starts():
    """A run's start has 16 bits: l_max 65,537 is refused by both packers."""
    reads = np.full((1, 65537), 4, np.int8)
    for pack in (tpack.pack_reads_2bit, tpack.pack_reads_2bit_plain):
        with pytest.raises(ValueError, match="16 bits"):
            pack(reads)


@pytest.mark.parametrize("l_max", [64, 160, 256, 32768])
def test_unpack_reads_plain_matches(l_max):
    """Including the pad entries of the ambiguity list (row B, dropped):
    kart_tpu's list of positions and the port's list of runs of the same
    reads unpack to kart_tpu's codes."""
    rng = np.random.default_rng(l_max)
    B = 21
    reads = random_codes(rng, B, l_max, 0.02)
    reads[3, l_max // 2 :] = reads[5] = 4
    words, amb_r, amb_p = jpack.pack_reads_2bit(reads)
    if l_max <= 256:  # past the last capacity bucket a list is its entries alone
        assert len(amb_r) > (amb_r < B).sum(), "the list must carry pad entries"
    want = np.asarray(jpack.unpack_reads_device(jnp.asarray(words), jnp.asarray(amb_r),
                                                jnp.asarray(amb_p), l_max))
    w = torch.from_numpy(words.view(np.int32))
    _, run_r, run_p = tpack.pack_reads_2bit(reads)
    assert len(run_r) > (run_r < B).sum() or l_max > 256
    assert (run_p >> 16).max() > 0
    for r, p in ((amb_r, amb_p), (run_r, run_p)):
        got = tpack.unpack_reads_plain(w, torch.from_numpy(r), torch.from_numpy(p), l_max)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy()[(reads > 3)], 4)


def test_unpack_reads_plain_clips_and_drops():
    """Runs that overlap, runs past l_max clipped, entries with a row out of
    [0, B), a negative amb_p or a start past l_max dropped."""
    B, l_max = 3, 100
    words = torch.zeros((B, 7), dtype=torch.int32)
    amb_r = torch.tensor([0, 0, 1, 2, 3, -1, 2, 2], dtype=torch.int32)
    amb_p = torch.tensor([10 | 9 << 16, 15 | 9 << 16, 90 | 99 << 16, 1, 5, 5, -1, 100],
                         dtype=torch.int32)
    want = np.zeros((B, l_max), np.int32)
    want[0, 10:25] = want[1, 90:] = want[2, 1] = 4
    np.testing.assert_array_equal(tpack.unpack_reads_plain(words, amb_r, amb_p, l_max).numpy(),
                                  want)


def stream_parts(rng, B, H):
    """A resolved stream triple with flagged (negative) counts and the -1
    fill past the last occurrence."""
    cnts = rng.integers(0, 40, B).astype(np.int32)
    flag = rng.random(B) < 0.3
    cnts[flag] = -cnts[flag] - 1
    n = H - 5
    meta = np.full(H, -1, np.int32)
    meta[:n] = rng.integers(0, 256, n) | (rng.integers(13, 257, n) << 16)
    gpos = np.full(H, -1, np.int32)
    gpos[:n] = rng.integers(0, 10**7, n)
    return cnts, meta, gpos


@pytest.mark.parametrize("pack16", [False, True])
def test_pack_stream_plain_matches(pack16):
    cnts, meta, gpos = stream_parts(np.random.default_rng(5), 32, 48)
    want = np.asarray(jpack._pack_stream(jnp.asarray(cnts), jnp.asarray(meta), jnp.asarray(gpos),
                                         pack16=pack16))
    got = tpack.pack_stream_plain(torch.from_numpy(cnts), torch.from_numpy(meta),
                                  torch.from_numpy(gpos), pack16=pack16)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if pack16:  # the -1 meta fill becomes 0xFEFF (kart_tpu's pack16 loses it)
        mw = got.numpy()[16:40].view(np.uint16)
        assert (mw[-5:] == 0xFEFF).all()


@pytest.mark.parametrize("pack16", [False, True])
def test_unpack_stream_matches(pack16):
    cnts, meta, gpos = stream_parts(np.random.default_rng(6), 40, 64)
    packed = np.asarray(jpack._pack_stream(jnp.asarray(cnts), jnp.asarray(meta),
                                           jnp.asarray(gpos), pack16=pack16))
    want = jpack.unpack_stream(packed, 40, 64, pack16)
    got = tpack.unpack_stream(packed, 40, 64, pack16)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], cnts)


# ---------------------------------------------------------------------------
# The SensitiveMode (PacBio) entry points: 32-bit streams
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sens_index(workdir):
    """The 20 kb random genome of tests/test_fm_kernels.py, its FM index in
    both packages and the funnel's tables."""
    from conftest import make_genome
    from kart_tpu.index import build_index, load_index
    from kart_tpu.ops import fm_search as jfm
    from kart_tpu.ops import kmer_seed as jks
    from kart_tpu_torch.ops import fm_search as tfm
    from kart_tpu_torch.ops import kmer_seed as tks

    d = workdir / "torch_pack_sens"
    d.mkdir(exist_ok=True)
    (d / "g.fa").write_text(make_genome(np.random.default_rng(5), [20000], n_runs=0))
    build_index(str(d / "g.fa"), str(d / "idx"), verbose=False)
    gidx = load_index(str(d / "idx"))
    tb = tks.build_tables(gidx, cache=False)
    return dict(gidx=gidx, jfm=jfm.FMIndexArrays.from_genome_index(gidx),
                tfm=tfm.FMIndexTensors.from_genome_index(gidx, "cpu"),
                jtb=jks.build_tables(gidx, cache=False), tb=tb,
                tt=tks.KmerTablesTensors.from_tables(tb, "cpu"),
                hit_cap=tks.hit_cap_for(tb.max_mult))


def sens_batch(gidx, case):
    """(reads int8 (B, l_max), rlens, l_max, occ budget) of one case."""
    from test_torch_kmer_seed import sensitive_batch

    if case == "s317":  # 4 reads of 2.6-3.4 kb at l_max 4096: max_seeds 317
        rng = np.random.default_rng(4)
        l_max = 4096
        reads = np.full((4, l_max), 4, np.int32)
        rlens = np.array([3400, 2600, 3000, 0], np.int32)
        for i, rl in enumerate(rlens):
            p = int(rng.integers(0, gidx.two_genome_size - 3500))
            r = gidx.ref_codes[p : p + rl].astype(np.int32)
            m = rng.random(rl) < 0.1
            r[m] = (r[m] + rng.integers(1, 4, int(m.sum()))) % 4
            reads[i, :rl] = r
        return reads.astype(np.int8), rlens, l_max, 4 * max(64, l_max // 24)
    reads, rlens = sensitive_batch(gidx, n=16, rlen=700, l_max=1024)
    budget = 16 * 64 if case == "b16" else 30  # the tight budget leaves reads out
    return reads.astype(np.int8), rlens, 1024, budget


@pytest.mark.parametrize("case", ["b16", "tight_budget", "s317"])
def test_sensitive_resolved_entry_points_match(sens_index, case):
    """sensitive_scan_packed, sensitive_scan_resolved_packed and
    kmer_seed_scan_resolved_packed(sensitive=True) against kart_tpu's, from
    the host packer's words to the 32-bit stream."""
    x = sens_index
    reads, rlens, l_max, H = sens_batch(x["gidx"], case)
    B = len(rlens)
    ms = l_max // 13 + 2
    words, amb_r, amb_p = jpack.pack_reads_2bit(reads)
    assert len(amb_r) > 4096, "the pad bases overrun the packer's first capacity"
    jargs = (jnp.asarray(words), jnp.asarray(amb_r), jnp.asarray(amb_p), jnp.asarray(rlens),
             np.int32(13))
    w2, r2, p2 = tpack.pack_reads_2bit(reads)
    np.testing.assert_array_equal(w2, words)
    assert_runs_of(r2, p2, amb_r, amb_p, B)
    targs = (torch.from_numpy(w2.view(np.int32)), torch.from_numpy(r2), torch.from_numpy(p2),
             torch.from_numpy(rlens), 13)
    kw = dict(max_seeds=ms, l_max=l_max)

    want = np.asarray(jpack.sensitive_scan_packed(x["jfm"], *jargs, **kw))
    got = tpack.sensitive_scan_packed(x["tfm"], *targs, **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)

    sa = x["tt"].sa_full
    want = np.asarray(jpack.sensitive_scan_resolved_packed(x["jfm"], *jargs, occ_budget=H, **kw))
    got = tpack.sensitive_scan_resolved_packed(x["tfm"], sa, *targs, occ_budget=H, **kw)
    assert got.dtype == torch.int32 and got.shape == (B + 2 * H,)
    np.testing.assert_array_equal(got.numpy(), want)
    fm_cnts = want[:B]

    jtb = x["jtb"]
    fk = dict(hit_cap=x["hit_cap"], rounds=l_max // 13 + 8, occ_budget=H, sensitive=True, **kw)
    want = np.asarray(jpack.kmer_seed_scan_resolved_packed(
        jtb.table_lo, jtb.text_words, jtb.sa_full, jtb.sub_tbl, *jargs, seq_len=jtb.seq_len, **fk))
    got = tpack.kmer_seed_scan_resolved_packed(x["tt"], *targs, **fk)
    assert got.dtype == torch.int32 and got.shape == (B + 2 * H,)
    np.testing.assert_array_equal(got.numpy(), want)
    cnts, meta, gpos = tpack.unpack_stream(want, B, H)
    if case == "tight_budget":
        assert (cnts < 0).sum() >= 6 and (cnts >= 0).sum() >= 2
    else:
        # the funnel is exact: the stream is the FM stepper's
        assert (cnts >= 0).all()
        np.testing.assert_array_equal(cnts, fm_cnts)
    if case == "s317":
        assert ms == 317 and cnts.max() > 30
        assert ((meta[: cnts[0]] & 0xFFFF) > 3000).any(), "rpos past 3,000 in the meta words"
