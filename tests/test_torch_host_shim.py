"""The CUDA kernels run on the CPU: `csrc/kmer_funnel.cu` (FastMode and
SensitiveMode), `csrc/resolve_pack.cu`, `csrc/fm_seed_scan.cu` (both
steppers) and `csrc/nw.cu` compiled as
host C++ against `tests/host_shim/cuda_shim.h` (threads as std::threads, a
warp's shuffles an exchange between its 32 threads, the
blocks of a cluster at the same time, cluster.sync() a barrier over all of
them, map_shared_rank a pointer into the peer's arena, the chained scan's
blocks four at a time) and held byte for byte against their plain versions,
which the other test files hold against kart_tpu.  This checks the kernels'
arithmetic, indexing and barrier placement; that nvcc accepts the sources
and that they are right on the card is chip_smoke.py's phase 4.
"""

import ctypes
import os

import numpy as np
import pytest
import torch

import kart_tpu_torch
from kart_tpu_torch.index import build_index, load_index
from kart_tpu_torch.ops import fm_search as tfm
from kart_tpu_torch.ops import kmer_seed as tks
from kart_tpu_torch.ops import nw as tnw
from kart_tpu_torch.ops import pack as tpack
from kart_tpu_torch.ops import resolve as tres
from host_shim import translate
from test_nw_kernel import random_pairs
from test_torch_kmer_seed import make_reads
from test_torch_resolve import seed_blocks

torch.set_num_threads(1)
_ACGT = np.frombuffer(b"ACGT", np.uint8)
MIN_SEED = 13
CLUSTER = 8
CSRC = os.path.join(os.path.dirname(os.path.abspath(kart_tpu_torch.__file__)), "csrc")


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    so = tmp_path_factory.mktemp("host_shim") / "libkarthost.so"
    translate.build(str(so), [os.path.join(CSRC, f) for f in (
        "kmer_funnel.cu", "resolve_pack.cu", "fm_seed_scan.cu", "nw.cu")])
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.kart_kmer_funnel.argtypes = [p, p, p, p, i, p, p, p, i, p, i, i, i, i, i, i, i, i, i,
                                     p, p, p]
    lib.kart_fm_sensitive_scan.argtypes = [p, p, p, i, p, p, i, i, i, i, i, p, p]
    lib.kart_fm_sensitive_scan.restype = i
    lib.kart_kmer_funnel.restype = i
    lib.kart_kmer_funnel_cluster.restype = i
    lib.kart_resolve_pack.argtypes = [p, i, i, i, p, i, i, p, p, p, p, p]
    lib.kart_resolve_pack.restype = i
    lib.kart_resolve_scan_words.argtypes = [i]
    lib.kart_resolve_scan_words.restype = i
    lib.kart_fm_seed_scan.argtypes = [p, p, p, i, p, p, i, i, i, i, p, p]
    lib.kart_fm_seed_scan.restype = i
    lib.kart_nw_planes.argtypes = [p, p, i, i, p, p]
    lib.kart_nw_planes.restype = i
    assert lib.kart_kmer_funnel_cluster() == CLUSTER
    return lib


@pytest.fixture(scope="module")
def shim_genome(workdir):
    """The ~36 kb genome of test_torch_kmer_seed: 40 copies (1% diverged) of
    a 300 bp element in random sequence, and a 40 bp poly-A run."""
    d = workdir / "torch_host_shim"
    d.mkdir(exist_ok=True)
    rng = np.random.default_rng(7)
    elem = _ACGT[rng.integers(0, 4, 300)]
    parts = []
    for _ in range(40):
        parts.append(_ACGT[rng.integers(0, 4, int(rng.integers(200, 800)))])
        e = elem.copy()
        m = rng.random(300) < 0.01
        e[m] = _ACGT[rng.integers(0, 4, int(m.sum()))]
        parts.append(e)
    parts += [np.full(40, ord("A"), np.uint8), _ACGT[rng.integers(0, 4, 5000)]]
    seq = np.concatenate(parts).tobytes().decode()
    fa = d / "g.fa"
    fa.write_text(">c1\n" + "\n".join(seq[j : j + 70] for j in range(0, len(seq), 70)) + "\n")
    build_index(str(fa), str(d / "idx"), verbose=False)
    gidx = load_index(str(d / "idx"))
    return gidx, tks.build_tables(gidx)


def ptr(a: np.ndarray) -> int:
    assert a.flags.c_contiguous
    return a.ctypes.data


def host_funnel(lib, tb, words, amb_r, amb_p, rlens, *, l_max, hit_cap, slab_rows, hit_budget,
                sensitive=False, ms=None, rounds=None):
    B = words.shape[0]
    ms = ms or l_max // (MIN_SEED + 1) + 1
    rounds = rounds or l_max // 10 + 4
    table_lo = np.ascontiguousarray(tb.table_lo_np, np.int32)
    sub_tbl = np.ascontiguousarray(tb.sub_tbl_np)
    sa = np.ascontiguousarray(tb.sa_full_np, np.int32)
    text = np.ascontiguousarray(tb.text_words_np())
    ambm = np.full((B, -(-l_max // 32)), -1, np.int32)  # scratch arrives as garbage
    out = np.full((B, 2 + 4 * ms), -7, np.int32)
    rc = lib.kart_kmer_funnel(ptr(table_lo), ptr(sub_tbl), ptr(sa), ptr(text), int(tb.seq_len),
                              ptr(words), ptr(amb_r), ptr(amb_p), len(amb_r), ptr(rlens), B, l_max,
                              MIN_SEED, ms, hit_cap, rounds, slab_rows, hit_budget, int(sensitive),
                              ptr(ambm), ptr(out), None)
    assert rc == 0
    return out


# name: (B, l_max, slab_rows, hit_budget, hit_cap or None for the tables')
FUNNEL_CASES = {
    "slabs_ragged": (400, 160, 128, 2, None),  # three slabs and a ragged fourth
    "flagged": (300, 160, 96, 1, 16),  # lanes overrun the budget and hit_cap
    "sub_slab": (300, 64, 4096, 2, None),  # one slab of B rows, 38 lanes a block
    "slab_not_divisible": (250, 256, 100, 2, None),  # 13 lanes a block, the last block 9
    # the last block's lanes past the slab belong to the next slab's budget
    "slab_not_divisible_flagged": (350, 64, 100, 1, 16),
    "fewer_rows_than_blocks": (5, 160, 4096, 2, None),  # blocks without a lane
}


@pytest.mark.parametrize("name", list(FUNNEL_CASES))
def test_funnel_kernel_on_host_matches_plain(host_lib, shim_genome, name):
    gidx, tb = shim_genome
    B, l_max, slab, hb, hit_cap = FUNNEL_CASES[name]
    hit_cap = hit_cap or tks.hit_cap_for(tb.max_mult)
    reads, rlens = make_reads(gidx, B, l_max, seed=l_max + B)
    words, amb_r, amb_p = tpack.pack_reads_2bit(reads.astype(np.int8))
    amb_r, amb_p = amb_r[::-1].copy(), amb_p[::-1].copy()  # no order of the list is assumed
    got = host_funnel(host_lib, tb, words, amb_r, amb_p, rlens, l_max=l_max, hit_cap=hit_cap,
                      slab_rows=slab, hit_budget=hb)
    tt = tks.KmerTablesTensors.from_tables(tb, "cpu")
    want = tks.kmer_seed_scan_plain(
        tt, torch.from_numpy(reads), torch.from_numpy(rlens), MIN_SEED,
        max_seeds=l_max // 14 + 1, l_max=l_max, hit_cap=hit_cap, rounds=l_max // 10 + 4,
        slab_rows=slab, hit_budget=hb,
    ).numpy()
    np.testing.assert_array_equal(got, want)
    assert (reads == 4).any() and want[:, 0].sum() > B // 2
    if name.endswith("flagged"):
        assert (want[:, 1] == 0).sum() > 10


def test_funnel_kernel_on_host_refuses_a_block_too_large(host_lib, shim_genome):
    """4,000 lanes a block at l_max 512 exceed a block's shared memory."""
    _, tb = shim_genome
    B, l_max = 32000, 512
    words = np.zeros((B, 32), np.uint32)
    none = np.zeros(0, np.int32)
    ms = l_max // 14 + 1
    out = np.zeros((B, 2 + 4 * ms), np.int32)
    ambm = np.zeros((B, 16), np.int32)
    rc = host_lib.kart_kmer_funnel(None, None, None, None, int(tb.seq_len), ptr(words), ptr(none),
                                   ptr(none), 0, ptr(np.zeros(B, np.int32)), B, l_max, MIN_SEED,
                                   ms, 16, 10, 32000, 2, 0, ptr(ambm), ptr(out), None)
    assert rc != 0


# name: (genome, B, l_max, slab_rows, hit_budget, rounds or None for the mapper's)
SENS_FUNNEL_CASES = {
    "b16_ragged": ("random", 16, 1024, 4096, 2, None),  # 2 lanes a block; short, pad, N lanes
    "one_read_l32768": ("random", 1, 32768, 4096, 2, None),  # seven blocks without a lane
    # three slabs of 24 and a ragged fourth, 3 lanes a block; every lane asks
    # for some 40 hits of a budget of 4 * 24
    "slabs_flagged": ("repeat", 80, 512, 24, 1, None),
    "budget_above_four": ("repeat", 20, 512, 4096, 9, None),  # H = 9 * B
    "rounds_cut": ("random", 16, 1024, 4096, 2, 20),  # unfinished lanes are flagged
}


@pytest.mark.parametrize("name", list(SENS_FUNNEL_CASES))
def test_sensitive_funnel_kernel_on_host_matches_plain(host_lib, shim_genome, name):
    from test_torch_kmer_seed import repeat_batch, sensitive_batch

    gidx, tb = shim_genome
    kind, B, l_max, slab, hb, rounds = SENS_FUNNEL_CASES[name]
    if kind == "repeat":
        reads, rlens = repeat_batch(gidx, B, l_max)
    elif B == 1:  # a read of exactly l_max bases, 12% substitutions, an N run
        rng = np.random.default_rng(5)
        r = gidx.ref_codes[100 : 100 + l_max].astype(np.int32)
        m = rng.random(l_max) < 0.12
        r[m] = (r[m] + rng.integers(1, 4, int(m.sum()))) % 4
        r[9000:9040] = 4
        reads, rlens = r[None, :].copy(), np.array([l_max], np.int32)
    else:
        reads, rlens = sensitive_batch(gidx, n=B, rlen=700, l_max=l_max)
        reads[2, 100:230] = 4  # a run of Ns longer than any window or word
    ms = l_max // MIN_SEED + 2
    rounds = rounds or l_max // MIN_SEED + 8
    hit_cap = tks.hit_cap_for(tb.max_mult)
    words, amb_r, amb_p = tpack.pack_reads_2bit(reads.astype(np.int8))
    got = host_funnel(host_lib, tb, words, amb_r, amb_p, rlens, l_max=l_max, hit_cap=hit_cap,
                      slab_rows=slab, hit_budget=max(hb, 4), sensitive=True, ms=ms, rounds=rounds)
    tt = tks.KmerTablesTensors.from_tables(tb, "cpu")
    want = tks.kmer_seed_scan_plain(
        tt, torch.from_numpy(reads), torch.from_numpy(rlens), MIN_SEED, max_seeds=ms,
        l_max=l_max, hit_cap=hit_cap, rounds=rounds, sensitive=True, slab_rows=slab,
        hit_budget=hb).numpy()
    np.testing.assert_array_equal(got, want)
    flagged = int((want[:, 1] == 0).sum())
    if name in ("slabs_flagged", "rounds_cut"):
        assert flagged >= 8
    elif name == "budget_above_four":  # 40 hits a lane fit a budget of 9 a lane four at a time
        assert 0 < flagged < B
    assert want[:, 0].sum() >= 2 * min(B, 8)
    if name == "one_read_l32768":
        assert want[0, 0] > 250 and want[0, 2 + want[0, 0] - 1] > 32000


def test_sensitive_funnel_kernel_on_host_refuses_l_max(host_lib):
    rc = host_lib.kart_kmer_funnel(None, None, None, None, 0, None, None, None, 0, None, 2, 32784,
                                   MIN_SEED, 9, 16, 10, 4096, 4, 1, None, None, None)
    assert rc != 0


def packed_seeds(rng, B, S, n_sa, has_ok, ok_frac):
    n_seeds, rpos, slen, k0, freq, ok_in = seed_blocks(rng, B, S, n_sa)
    ok_in = rng.random(B) < ok_frac
    cols = [n_seeds[:, None]] + ([ok_in.astype(np.int32)[:, None]] if has_ok else [])
    return np.ascontiguousarray(np.concatenate(cols + [rpos, slen, k0, freq], axis=1), np.int32)


# name: (B, S, H, has_ok, pack16, share of reads that are ok)
RESOLVE_CASES = {
    "one_block": (40, 6, 90, True, False, 0.8),
    "block_edge": (256, 12, 600, True, True, 0.8),
    "not_a_multiple_of_the_block": (1000, 12, 4000, True, True, 0.8),  # 4 blocks at once
    "fm_layout": (998, 9, 64 * 998, False, True, 1.0),  # the re-seed batches' layout
    # 36 blocks, and a budget that the reads of the last blocks still fit
    "look_back_past_32_blocks": (9000, 5, 64000, True, True, 0.9),
    # the PacBio path's rows in the 32-bit layout: 632 seeds a read at l_max
    # 8192 (a totals tile is 256 reads by S columns), 2,522 at l_max 32768
    "pacbio_rows": (300, 632, 300 * 341, True, False, 0.9),
    "l_max_32768_rows": (16, 2522, 16 * 1365, False, False, 1.0),
    "budget_zero": (300, 6, 0, True, True, 0.8),
    "all_flagged": (300, 6, 1200, True, False, 0.0),
    "no_reads": (0, 6, 64, True, True, 1.0),
}


@pytest.mark.parametrize("name", list(RESOLVE_CASES))
def test_resolve_pack_kernel_on_host_matches_plain(host_lib, name):
    B, S, H, has_ok, pack16, ok_frac = RESOLVE_CASES[name]
    rng = np.random.default_rng(B + H)
    sa = rng.permutation(6000).astype(np.int32)
    packed = packed_seeds(rng, B, S, len(sa), has_ok, ok_frac)
    n = (B // 2 + H // 2 + H) if pack16 else (B + 2 * H)
    out = np.full(n, -7, np.int32)
    read_end, cnts = np.full(B, -7, np.int32), np.full(B, -7, np.int32)
    state = np.full(host_lib.kart_resolve_scan_words(B), -1, np.int64)
    rc = host_lib.kart_resolve_pack(ptr(packed), B, int(has_ok), S, ptr(sa), H, int(pack16),
                                    ptr(read_end), ptr(cnts), ptr(state), ptr(out), None)
    assert rc == 0
    if B:
        want = tres.resolve_pack_plain(torch.from_numpy(sa), torch.from_numpy(packed), max_seeds=S,
                                       has_ok=has_ok, occ_budget=H, pack16=pack16).numpy()
    else:  # an empty batch: the stream is its fill
        fill = torch.full((H,), -1, dtype=torch.int32)
        want = tres.pack_stream_plain(torch.zeros(0, dtype=torch.int32), fill, fill, pack16).numpy()
    np.testing.assert_array_equal(out, want)
    if name == "all_flagged":
        assert (cnts < 0).all()


def fm_edge_reads(gidx, l_max):
    """Reads at the stepper's edges: pad lanes (rlen 0), reads shorter than
    the minimal seed, of exactly that length and one more, an all-N read,
    an N first, last and in a run, a read that ends at l_max, and windows
    around the texts of the suffix-array rows next to `primary`, both
    strands: halfway through such a read the interval of its reverse
    complement ends just before, or starts just after, the row the BWT
    skips."""
    rng = np.random.default_rng(3)
    lens = [0, 5, MIN_SEED - 1, MIN_SEED, MIN_SEED + 1, 60, l_max, 0, 70, 70, 70, l_max, 40, 0]
    reads = np.full((len(lens), l_max), 4, np.int32)
    for k, rl in enumerate(lens):
        p = int(rng.integers(0, gidx.two_genome_size - l_max))
        reads[k, :rl] = gidx.ref_codes[p : p + rl]
    reads[5, :60] = 4  # all N, rlen 60
    reads[8, 0] = 4
    reads[9, 69] = 4
    reads[10, 30:34] = 4
    reads[12, 40:] = 7  # codes past rlen need not be 4
    lens = np.array(lens, np.int32)
    around = []
    for row in (gidx.primary - 1, gidx.primary + 1):
        pos = int(gidx.sa_full[row])
        if 30 <= pos <= gidx.two_genome_size - 30:
            text = gidx.ref_codes[pos - 30 : pos + 30].astype(np.int32)
            around += [text, 3 - text[::-1]]
    extra = np.full((len(around), l_max), 4, np.int32)
    extra[:, :60] = around
    return np.concatenate([reads, extra]), np.concatenate([lens, np.full(len(around), 60, np.int32)])


# name: (B, l_max, max_seeds or None for the mapper's)
FM_CASES = {
    "one_read": (1, 100, None),
    "ragged_127": (127, 100, None),  # 15 blocks and 7 reads of a 16th
    "edges": (None, 80, None),
    "seeds_dropped": (24, 100, 2),  # more seeds than slots
    "reseed_layout": (2048, 160, None),  # the re-seed batch: 100 real lanes, then pads
    "odd_l_max": (9, 151, None),  # rows of an odd length; one block and a read of a second
    "short_l_max": (40, 37, None),  # fewer columns than the lanes of three sweeps
}


@pytest.mark.parametrize("name", list(FM_CASES))
def test_fm_seed_scan_kernel_on_host_matches_plain(host_lib, shim_genome, name):
    gidx, _ = shim_genome
    B, l_max, ms = FM_CASES[name]
    ms = ms or l_max // (MIN_SEED + 1) + 1
    if name == "edges":
        reads, rlens = fm_edge_reads(gidx, l_max)
    elif name == "reseed_layout":
        reads = np.full((B, l_max), 4, np.int32)
        rlens = np.zeros(B, np.int32)
        reads[:100], rlens[:100] = make_reads(gidx, 100, l_max, seed=5)
    else:
        reads, rlens = make_reads(gidx, B, l_max, seed=B)
        if name == "seeds_dropped":  # every tenth base wrong: many short seeds
            reads[:, 14::15] = (reads[:, 14::15] + 1) % 4
    B = len(reads)
    fm = tfm.FMIndexTensors.from_genome_index(gidx, "cpu")
    want = tfm.seed_scan_plain(fm, torch.from_numpy(reads), torch.from_numpy(rlens), MIN_SEED,
                               max_seeds=ms, l_max=l_max).numpy()
    out = np.full((B, 1 + 4 * ms), -7, np.int32)
    rc = host_lib.kart_fm_seed_scan(ptr(fm.occ_cp.numpy()), ptr(fm.bwt_words.numpy()),
                                    ptr(fm.L2.numpy()), fm.primary, ptr(reads), ptr(rlens), B,
                                    l_max, MIN_SEED, ms, ptr(out), None)
    assert rc == 0
    np.testing.assert_array_equal(out, want)
    if name == "seeds_dropped":
        assert (want[:, 0] > ms).any()
    elif name == "edges":
        assert (want[[0, 1, 2, 3, 5, 7, 13]] == 0).all() and want[:, 0].sum() >= 6
    else:
        assert want[:, 0].sum() >= min(B, 100) // 2


# name: (static l_max or None for the reads' width, max_seeds or None for the mapper's)
FM_SENS_CASES = {
    "long": (None, None),
    "ragged": (None, None),  # pad lanes, reads around MinSeed, all-N, a clean read
    "trip_cut": (13, None),  # max_trips = 31 * 3 cuts every read
    "dropped": (None, 3),  # seeds past max_seeds are dropped and not counted
    "rewind": (None, None),  # start + MinSeed < p after a seed with too many occurrences
}


@pytest.mark.parametrize("name", list(FM_SENS_CASES))
def test_fm_sensitive_scan_kernel_on_host_matches_plain(host_lib, shim_genome, workdir, name):
    from test_torch_fm_search import _sensitive_reads, tandem_index, tandem_reads

    gidx, _ = shim_genome
    if name == "rewind":
        gidx = tandem_index(workdir, "torch_shim_tandem")
        reads, rlens = tandem_reads(gidx)
        l_max, ms = reads.shape[1], reads.shape[1] // MIN_SEED + 2
    else:
        reads, rlens, l_max, ms = _sensitive_reads(gidx, name)
        reads[0, rlens[0]:] = 7  # codes past rlen need not be 4
    B, width = reads.shape
    fm = tfm.FMIndexTensors.from_genome_index(gidx, "cpu")
    want = tfm.sensitive_scan_plain(fm, torch.from_numpy(reads), torch.from_numpy(rlens),
                                    MIN_SEED, max_seeds=ms, l_max=l_max).numpy()
    out = np.full((B, 1 + 4 * ms), -7, np.int32)
    rc = host_lib.kart_fm_sensitive_scan(
        ptr(fm.occ_cp.numpy()), ptr(fm.bwt_words.numpy()), ptr(fm.L2.numpy()), fm.primary,
        ptr(reads), ptr(rlens), B, width, MIN_SEED, ms, 31 * (l_max // MIN_SEED + 2), ptr(out),
        None)
    assert rc == 0
    np.testing.assert_array_equal(out, want)
    assert want[:, 0].sum() >= 10
    if name == "dropped":
        assert (want[:, 0] == ms).any()
    elif name == "trip_cut":
        assert want[:, 0].max() <= 4


def test_fm_seed_scan_kernel_on_host_refuses_reads_too_long(host_lib):
    """Eight reads of 60,000 bases exceed a block's shared memory."""
    rc = host_lib.kart_fm_seed_scan(None, None, None, 0, None, None, 8, 60000, MIN_SEED, 4000,
                                    None, None)
    assert rc != 0


# n: pairs a launch; one pair, a ragged warp's worth past a block, and more
# pairs than a block of any tile holds
@pytest.mark.parametrize("n", [1, 33, 70])
@pytest.mark.parametrize("lm", [16, 32, 64, 128])
def test_nw_kernel_on_host_matches_plain(host_lib, lm, n):
    rng = np.random.default_rng(1000 * lm + n)
    pairs = [p for p in random_pairs(3 * n, rng, max_len=lm, with_n=True)
             if max(map(len, p)) <= lm][: n - 1]
    pairs += [(b"A" * lm, b"C")] * (n - len(pairs))  # a full first string against one base
    c1, c2 = tnw.encode_tile(pairs, lm)
    want = tnw.nw_batch_planes_plain(torch.from_numpy(c1), torch.from_numpy(c2), lm=lm).numpy()
    # the planes start at any byte of a 16-byte line
    buf = np.full(n * (lm + 1) ** 2 + 16, 0xEE, np.uint8)
    off = (n + lm) % 16
    out = buf[off : off + n * (lm + 1) ** 2]
    rc = host_lib.kart_nw_planes(ptr(c1), ptr(c2), n, lm, out.ctypes.data, None)
    assert rc == 0
    np.testing.assert_array_equal(out.reshape(want.shape), want)
    assert (buf[:off] == 0xEE).all() and (buf[off + out.size :] == 0xEE).all()
    for k in range(0, n, 7):
        assert tnw.nw_backtrace(want[k], *pairs[k]) == tnw.nw_alignment(*pairs[k])


def test_nw_kernel_on_host_refuses_an_unsupported_tile(host_lib):
    assert host_lib.kart_nw_planes(None, None, 4, 48, None, None) != 0
