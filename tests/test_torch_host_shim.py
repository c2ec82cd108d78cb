"""The CUDA kernels run on the CPU: `csrc/kmer_funnel.cu` (FastMode and
SensitiveMode), `csrc/resolve_pack.cu` (full and sampled SA, int32 and
int64), `csrc/fm_seed_scan.cu` (both steppers, both index types),
`csrc/sa_walk.cu`, `csrc/nw.cu`, `csrc/cluster.cu`, `csrc/pairing.cu` and
`csrc/sharded_fm.cu` (the sharded index's step kernels; its resident scan
and walk are fm_seed_scan.cu's and sa_walk.cu's) compiled as
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
from kart_tpu_torch import kernels
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
        "kmer_funnel.cu", "resolve_pack.cu", "fm_seed_scan.cu", "nw.cu", "sa_walk.cu",
        "cluster.cu", "pairing.cu", "sharded_fm.cu")])
    lib = ctypes.CDLL(str(so))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for sfx, prim in (("", i), ("_i64", ll)):
        getattr(lib, "kart_sa_walk" + sfx).argtypes = [p, p, p, p, prim, p, i, i, p, p, p]
        getattr(lib, "kart_fm_seed_scan" + sfx).argtypes = [p, p, p, prim, p, p, i, i, i, i, p, p]
        getattr(lib, "kart_fm_sensitive_scan" + sfx).argtypes = [p, p, p, prim, p, p, i, i, i, i,
                                                                 i, p, ll, p, p]
        getattr(lib, "kart_resolve_rows" + sfx).argtypes = [p, i, i, i, p, i, p, p, p, p, p, p, p]
        getattr(lib, "kart_sharded_seed_scan" + sfx).argtypes = [p, i, ll, p, prim, p, p, i, i, i,
                                                                 i, p, p]
        getattr(lib, "kart_sharded_sa_walk" + sfx).argtypes = [p, i, ll, ll, p, prim, p, i, i, p,
                                                               p, p]
        getattr(lib, "kart_sharded_occ4" + sfx).argtypes = [p, i, ll, prim, p, i, p, p]
        getattr(lib, "kart_sharded_fused_step" + sfx).argtypes = [p, i, ll, p, i, p, p, p, p, prim,
                                                                  i, i, i, i, i, p, p, p, p, p, p,
                                                                  p]
        getattr(lib, "kart_sharded_inv_psi" + sfx).argtypes = [p, i, ll, p, prim, p, i, p, p, p]
        getattr(lib, "kart_sharded_gather" + sfx).argtypes = [p, i, ll, p, i, i, p, p]
    lib.kart_resolve_finish.argtypes = [p, i, i, i, i, i, p, p, p, p, p, p, p]
    lib.kart_resolve_finish_i64.argtypes = [p, i, i, i, i, p, p, p, p, p, p, p]
    lib.kart_kmer_funnel.argtypes = [p, p, p, p, i, p, p, p, i, p, i, i, i, i, i, i, i, i, i,
                                     p, p, ctypes.c_longlong, p, p, p, p]
    lib.kart_fm_sensitive_scan.argtypes = [p, p, p, i, p, p, i, i, i, i, i, p, ctypes.c_longlong,
                                           p, p]
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
    lib.kart_cluster_illumina.argtypes = [p, i, p, p, p, p, p, i, i, i, p, p, p, p]
    lib.kart_cluster_illumina.restype = i
    lib.kart_pair_candidates.argtypes = [p, p, p, p, i, i, i, i, p, p, p, p]
    lib.kart_pair_candidates.restype = i
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
                sensitive=False, ms=None, rounds=None, tile=None, paths=None):
    """The funnel through the host shim.  SensitiveMode's scratch holds
    `tile` rows (all of them by default), of which the kernels use whole
    slabs; `paths`, a (2,) int32 array, gains the slabs of each path."""
    B = words.shape[0]
    ms = ms or l_max // (MIN_SEED + 1) + 1
    rounds = rounds or l_max // 10 + 4
    table_lo = np.ascontiguousarray(tb.table_lo_np, np.int32)
    sub_tbl = np.ascontiguousarray(tb.sub_tbl_np)
    sa = np.ascontiguousarray(tb.sa_full_np, np.int32)
    text = np.ascontiguousarray(tb.text_words_np())
    # scratch arrives as garbage
    ambm = np.full((B, -(-l_max // 32)), -1, np.int32)
    n_slabs = -(-B // min(B, slab_rows))
    cap = (tile or B) * l_max
    scr = np.full((cap, 2), -5, np.int32)
    totals = np.full(n_slabs * rounds, -9, np.int32)
    paths = np.zeros(2, np.int32) if paths is None else paths
    out = np.full((B, 2 + 4 * ms), -7, np.int32)
    rc = lib.kart_kmer_funnel(ptr(table_lo), ptr(sub_tbl), ptr(sa), ptr(text), int(tb.seq_len),
                              ptr(words), ptr(amb_r), ptr(amb_p), len(amb_r), ptr(rlens), B, l_max,
                              MIN_SEED, ms, hit_cap, rounds, slab_rows, hit_budget, int(sensitive),
                              ptr(ambm), ptr(scr), cap, ptr(totals), ptr(paths), ptr(out), None)
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
                                   ms, 16, 10, 32000, 2, 0, ptr(ambm), None, 0, None, None,
                                   ptr(out), None)
    assert rc != 0


# name: (genome, B, l_max, slab_rows, hit_budget, rounds or None for the mapper's, rows a
# tile of the scratch or None for all, the slabs (chased, replayed))
SENS_FUNNEL_CASES = {
    # short, pad and N lanes; a budget of 4 a lane, which some round overruns
    "b16_ragged": ("random", 16, 1024, 4096, 2, None, None, (0, 1)),
    # the same at a budget of 8 a lane, which every round fits
    "b16_ragged_chased": ("random", 16, 1024, 4096, 8, None, None, (1, 0)),
    # a read of exactly l_max bases, an all-N read, a read below MinSeed, pad
    # lanes; a budget of 4 a lane, then one of 16 that every round fits
    "one_read_l32768": ("long", 5, 32768, 4096, 2, None, None, (0, 1)),
    "one_read_l32768_chased": ("long", 5, 32768, 4096, 16, None, None, (1, 0)),
    # three slabs of 24 and a ragged fourth, 3 lanes a block; every lane asks
    # for some 40 hits of a budget of 4 * 24
    "slabs_flagged": ("repeat", 80, 512, 24, 1, None, None, (0, 4)),
    "budget_above_four": ("repeat", 20, 512, 4096, 9, None, None, (0, 1)),  # H = 9 * B
    # unfinished lanes are flagged, at a budget some round overruns and at one all fit
    "rounds_cut": ("random", 16, 1024, 4096, 2, 20, None, (0, 1)),
    "rounds_cut_chased": ("random", 16, 1024, 4096, 8, 20, None, (1, 0)),
    # one slab of random reads whose rounds fit and one of the repeat whose
    # rounds overrun H: both paths in one call
    "both_paths": ("mixed", 48, 512, 24, 8, None, None, (1, 1)),
    # slabs of 4 rows in a scratch of 14, which the kernels use as tiles of
    # three whole slabs: rows in tiles of 12 and 4, each slab replayed
    "tiles": ("random", 16, 1024, 4, 8, None, 14, (0, 4)),
    # two slabs a tile, the second overrunning: replayed with the tile's outcomes
    "slabs_in_tiles": ("mixed", 48, 512, 24, 8, None, 48, (1, 1)),
}


@pytest.mark.parametrize("name", list(SENS_FUNNEL_CASES))
def test_sensitive_funnel_kernel_on_host_matches_plain(host_lib, shim_genome, name):
    from test_torch_kmer_seed import repeat_batch, sensitive_batch

    gidx, tb = shim_genome
    kind, B, l_max, slab, hb, rounds, tile, want_paths = SENS_FUNNEL_CASES[name]
    if kind == "repeat":
        reads, rlens = repeat_batch(gidx, B, l_max)
    elif kind == "long":
        reads, rlens = long_edge_reads(gidx, l_max)
    elif kind == "mixed":
        reads, rlens = (np.concatenate(x) for x in zip(
            sensitive_batch(gidx, n=24, rlen=400, l_max=l_max), repeat_batch(gidx, 24, l_max)))
    else:
        reads, rlens = sensitive_batch(gidx, n=B, rlen=700, l_max=l_max)
        reads[2, 100:230] = 4  # a run of Ns longer than any window or word
    ms = l_max // MIN_SEED + 2
    rounds = rounds or l_max // MIN_SEED + 8
    hit_cap = tks.hit_cap_for(tb.max_mult)
    words, amb_r, amb_p = tpack.pack_reads_2bit(reads.astype(np.int8))
    paths = np.full(2, 100, np.int32)
    got = host_funnel(host_lib, tb, words, amb_r, amb_p, rlens, l_max=l_max, hit_cap=hit_cap,
                      slab_rows=slab, hit_budget=max(hb, 4), sensitive=True, ms=ms, rounds=rounds,
                      tile=tile, paths=paths)
    tt = tks.KmerTablesTensors.from_tables(tb, "cpu")
    want = tks.kmer_seed_scan_plain(
        tt, torch.from_numpy(reads), torch.from_numpy(rlens), MIN_SEED, max_seeds=ms,
        l_max=l_max, hit_cap=hit_cap, rounds=rounds, sensitive=True, slab_rows=slab,
        hit_budget=hb).numpy()
    np.testing.assert_array_equal(got, want)
    assert tuple(paths - 100) == want_paths
    flagged = int((want[:, 1] == 0).sum())
    if name in ("slabs_flagged", "rounds_cut", "rounds_cut_chased"):
        assert flagged >= 8
    elif name in ("budget_above_four", "both_paths"):
        # 40 hits a lane fit a budget of 9 a lane four at a time; the random
        # slab's lanes all fit
        assert 0 < flagged < B
    assert want[:, 0].sum() >= 2 * min(B, 8)
    if name.startswith("one_read_l32768"):
        assert want[0, 0] > 250 and want[0, 2 + want[0, 0] - 1] > 32000
        assert (want[1:, 0] == 0).all() and (want[1:, 1] == 1).all()


def test_sensitive_funnel_kernel_on_host_budget_edge(host_lib, shim_genome):
    """One repeat lane whose busiest round asks for M hits: a budget of M
    fits every round (the chase is exact), M - 1 overruns one (the replay)."""
    from test_torch_kmer_seed import repeat_batch

    gidx, tb = shim_genome
    l_max, ms, rounds = 512, 512 // MIN_SEED + 2, 512 // MIN_SEED + 8
    reads, rlens = repeat_batch(gidx, 1, l_max)
    tt = tks.KmerTablesTensors.from_tables(tb, "cpu")
    hit_cap = tks.hit_cap_for(tb.max_mult)
    kw = dict(max_seeds=ms, l_max=l_max, hit_cap=hit_cap, rounds=rounds, sensitive=True)
    stats: list = []
    tks.kmer_seed_scan_plain(tt, torch.from_numpy(reads), torch.from_numpy(rlens), MIN_SEED,
                             hit_budget=10**6, stats=stats, **kw)
    M = max(stats[0]["hits"])
    assert M > 4
    words, amb_r, amb_p = tpack.pack_reads_2bit(reads.astype(np.int8))
    oks = []
    for hb, want_paths in ((M, (1, 0)), (M - 1, (0, 1))):
        paths = np.zeros(2, np.int32)
        got = host_funnel(host_lib, tb, words, amb_r, amb_p, rlens, l_max=l_max, hit_cap=hit_cap,
                          slab_rows=4096, hit_budget=hb, sensitive=True, ms=ms, rounds=rounds,
                          paths=paths)
        want = tks.kmer_seed_scan_plain(tt, torch.from_numpy(reads), torch.from_numpy(rlens),
                                        MIN_SEED, hit_budget=hb, **kw).numpy()
        np.testing.assert_array_equal(got, want)
        assert tuple(paths) == want_paths
        oks.append(int(want[0, 1]))
    assert oks == [1, 0]


def test_sensitive_funnel_kernel_on_host_refuses_l_max(host_lib):
    rc = host_lib.kart_kmer_funnel(None, None, None, None, 0, None, None, None, 0, None, 2, 32784,
                                   MIN_SEED, 9, 16, 10, 4096, 4, 1, None, None, 1 << 20, None, None,
                                   None, None, None)
    assert rc != 0


def test_sensitive_funnel_kernel_on_host_refuses_a_row_wider_than_its_scratch(host_lib):
    rc = host_lib.kart_kmer_funnel(None, None, None, None, 0, None, None, None, 0, None, 2, 1024,
                                   MIN_SEED, 9, 16, 10, 4096, 4, 1, None, None, 1023, None, None,
                                   None, None)
    assert rc != 0


@pytest.mark.parametrize("B, slab_rows, cap", [
    (2, 4096, 2 * 1024 - 1),  # a slab of two rows, a scratch of less than two
    (6, 3, 3 * 1024 - 1),  # slabs of three rows
    # a slab the replay cannot hold
    (kernels.FUNNEL_SLAB_MAX + 1, 8192, (kernels.FUNNEL_SLAB_MAX + 1) * 1024),
])
def test_sensitive_funnel_kernel_on_host_refuses_a_slab_its_scratch_or_replay_cannot_hold(
        host_lib, B, slab_rows, cap):
    rc = host_lib.kart_kmer_funnel(None, None, None, None, 0, None, None, None, 0, None, B, 1024,
                                   MIN_SEED, 9, 16, 10, slab_rows, 4, 1, None, None, cap, None,
                                   None, None, None)
    assert rc != 0


@pytest.fixture(scope="module")
def poly_a_genome(workdir):
    """A 33 kb run of A between two random flanks of 2 kb: the 13-mer of As
    has 32,989 hits, more than the outcome word's hit count field holds."""
    d = workdir / "torch_host_shim_poly_a"
    d.mkdir(exist_ok=True)
    rng = np.random.default_rng(11)
    seq = np.concatenate([_ACGT[rng.integers(0, 4, 2000)], np.full(33000, ord("A"), np.uint8),
                          _ACGT[rng.integers(0, 4, 2000)]]).tobytes().decode()
    fa = d / "g.fa"
    fa.write_text(">c1\n" + "\n".join(seq[j : j + 70] for j in range(0, len(seq), 70)) + "\n")
    build_index(str(fa), str(d / "idx"), verbose=False)
    gidx = load_index(str(d / "idx"))
    return gidx, tks.build_tables(gidx)


def test_sensitive_funnel_kernel_on_host_hit_count_past_its_field(host_lib, poly_a_genome):
    """Lane 0 reads into the run of As, whose rounds ask for 32,989 hits, more
    than the outcome word's hit count field holds; lane 1 is a unique read
    after it in the budget's order.  A budget of the busiest round's M hits
    fits every round (chased); one of M - 2 (H still past the field) leaves
    lane 1 no room in those rounds (replayed, lane 1 flagged): a kernel that
    took the clamped field for the count there would give lane 1 its hits.
    A budget of 4 a lane (H below the field) takes the field as it stands."""
    gidx, tb = poly_a_genome
    l_max, ms, rounds = 512, 512 // MIN_SEED + 2, 512 // MIN_SEED + 8
    reads = np.full((2, l_max), 4, np.int32)
    reads[0, :300] = gidx.ref_codes[1850:2150]
    reads[1, :300] = gidx.ref_codes[35300:35600]
    rlens = np.array([300, 300], np.int32)
    tt = tks.KmerTablesTensors.from_tables(tb, "cpu")
    hit_cap = tks.hit_cap_for(tb.max_mult)
    kw = dict(max_seeds=ms, l_max=l_max, hit_cap=hit_cap, rounds=rounds, sensitive=True)
    stats: list = []
    tks.kmer_seed_scan_plain(tt, torch.from_numpy(reads), torch.from_numpy(rlens), MIN_SEED,
                             hit_budget=10**6, stats=stats, **kw)
    M = max(stats[0]["hits"])
    assert 32767 < M - 2 and M <= 2 * hit_cap
    words, amb_r, amb_p = tpack.pack_reads_2bit(reads.astype(np.int8))
    oks = []
    for hb, want_paths in (((M + 1) // 2, (1, 0)), ((M - 2) // 2, (0, 1)), (4, (0, 1))):
        paths = np.zeros(2, np.int32)
        got = host_funnel(host_lib, tb, words, amb_r, amb_p, rlens, l_max=l_max, hit_cap=hit_cap,
                          slab_rows=4096, hit_budget=hb, sensitive=True, ms=ms, rounds=rounds,
                          paths=paths)
        want = tks.kmer_seed_scan_plain(tt, torch.from_numpy(reads), torch.from_numpy(rlens),
                                        MIN_SEED, hit_budget=hb, **kw).numpy()
        np.testing.assert_array_equal(got, want)
        assert tuple(paths) == want_paths and want[1, 0] > 0
        oks.append(int(want[1, 1]))
    assert oks == [1, 0, 0]


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


def host_sensitive_scan(lib, fm, reads, rlens, *, l_max, ms, tile=None):
    """The SensitiveMode FM stepper through the host shim; `tile` reads a
    tile of the extension scratch (all of them by default)."""
    B, width = reads.shape
    cap = (tile or B) * width
    ext = np.full((cap, 2), -3, np.int32)  # scratch arrives as garbage
    out = np.full((B, 1 + 4 * ms), -7, np.int32)
    rc = lib.kart_fm_sensitive_scan(
        ptr(fm.occ_cp.numpy()), ptr(fm.bwt_words.numpy()), ptr(fm.L2.numpy()), fm.primary,
        ptr(reads), ptr(rlens), B, width, MIN_SEED, ms, 31 * (l_max // MIN_SEED + 2), ptr(ext), cap,
        ptr(out), None)
    assert rc == 0
    return out


def long_edge_reads(gidx, l_max):
    """A read of exactly l_max bases (12% substitutions, a run of Ns), an
    all-N read, a read shorter than the minimal seed, and pad lanes."""
    rng = np.random.default_rng(5)
    r = gidx.ref_codes[100 : 100 + l_max].astype(np.int32)
    m = rng.random(l_max) < 0.12
    r[m] = (r[m] + rng.integers(1, 4, int(m.sum()))) % 4
    r[9000:9040] = 4
    reads = np.full((5, l_max), 4, np.int32)
    reads[0] = r
    reads[3, : MIN_SEED - 1] = r[200 : 200 + MIN_SEED - 1]
    return reads, np.array([l_max, 0, 900, MIN_SEED - 1, 0], np.int32)


# name: (static l_max or None for the reads' width, max_seeds or None for the
# mapper's, reads a tile of the extension scratch or None for all)
FM_SENS_CASES = {
    "long": (None, None, None),
    "ragged": (None, None, None),  # pad lanes, reads around MinSeed, all-N, a clean read
    "trip_cut": (13, None, None),  # max_trips = 31 * 3 cuts every read
    "dropped": (None, 3, None),  # seeds past max_seeds are dropped and not counted
    "rewind": (None, None, None),  # start + MinSeed < p after a seed with too many occurrences
    "tiles": (None, None, 5),  # 12 reads in tiles of 5, 5 and 2
    "l_max_32768": (None, None, None),  # a read of exactly l_max bases, all-N, short and pad lanes
}


@pytest.mark.parametrize("name", list(FM_SENS_CASES))
def test_fm_sensitive_scan_kernel_on_host_matches_plain(host_lib, shim_genome, workdir, name):
    from test_torch_fm_search import _sensitive_reads, tandem_index, tandem_reads

    gidx, _ = shim_genome
    l_max, ms, tile = FM_SENS_CASES[name]
    if name == "rewind":
        gidx = tandem_index(workdir, "torch_shim_tandem")
        reads, rlens = tandem_reads(gidx)
        l_max, ms = reads.shape[1], reads.shape[1] // MIN_SEED + 2
    elif name == "l_max_32768":
        reads, rlens = long_edge_reads(gidx, 32768)
        l_max, ms = 32768, 32768 // MIN_SEED + 2
    else:
        reads, rlens, l_max, ms = _sensitive_reads(gidx, "long" if name == "tiles" else name)
        reads[0, rlens[0]:] = 7  # codes past rlen need not be 4
    fm = tfm.FMIndexTensors.from_genome_index(gidx, "cpu")
    stats: dict = {}
    want = tfm.sensitive_scan_plain(fm, torch.from_numpy(reads), torch.from_numpy(rlens),
                                    MIN_SEED, max_seeds=ms, l_max=l_max, stats=stats).numpy()
    got = host_sensitive_scan(host_lib, fm, reads, rlens, l_max=l_max, ms=ms, tile=tile)
    np.testing.assert_array_equal(got, want)
    assert want[:, 0].sum() >= 10
    if name == "dropped":
        assert (want[:, 0] == ms).any()
    elif name == "trip_cut":
        assert want[:, 0].max() <= 4 and (stats["trips"] == 31 * 3).all()
    elif name == "rewind":
        # a seed failed on its occurrences after more than MinSeed bases: the
        # scan went back behind the base it had reached
        assert (stats["trips"].numpy() > rlens + 2 * MIN_SEED).any()
    elif name == "l_max_32768":
        assert want[0, 0] > 250 and (want[1:, 0] == 0).all()


def test_fm_sensitive_scan_kernel_on_host_trip_limits(host_lib, shim_genome):
    """The trip limit at eight values, 93 to 310 trips: it cuts each read
    inside a run of Ns, inside an extension and on the trip that records a
    seed and starts the next, so a trip counted too many or too few shows."""
    from test_torch_fm_search import _sensitive_reads

    gidx, _ = shim_genome
    reads, rlens, _, ms = _sensitive_reads(gidx, "trip_cut")
    reads[1, 20:80] = 4  # 60 idle trips early in a read
    fm = tfm.FMIndexTensors.from_genome_index(gidx, "cpu")
    for l_max in range(MIN_SEED, 9 * MIN_SEED, MIN_SEED):
        want = tfm.sensitive_scan_plain(fm, torch.from_numpy(reads), torch.from_numpy(rlens),
                                        MIN_SEED, max_seeds=ms, l_max=l_max).numpy()
        got = host_sensitive_scan(host_lib, fm, reads, rlens, l_max=l_max, ms=ms)
        np.testing.assert_array_equal(got, want, err_msg=f"l_max {l_max}")


def test_fm_sensitive_scan_kernel_on_host_refuses_a_read_wider_than_its_scratch(host_lib):
    rc = host_lib.kart_fm_sensitive_scan(None, None, None, 0, None, None, 2, 600, MIN_SEED, 40,
                                         93, None, 599, None, None)
    assert rc != 0


def test_sensitive_scratch_rows():
    assert kernels.sens_scratch_rows(640, 8192) == 640
    assert kernels.sens_scratch_rows(4096, 32768) == kernels.SENS_SCRATCH // 32768
    with pytest.raises(ValueError, match="exceeds"):
        kernels.sens_scratch_rows(1, kernels.SENS_SCRATCH + 1)


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


def test_funnel_tile_rows():
    """Whole slabs a tile, as many as SENS_SCRATCH positions take and at
    least one; a slab the replay cannot hold is refused."""
    assert kernels.funnel_tile_rows(640, 8192, 4096) == 640
    assert kernels.funnel_tile_rows(640, 32768, 4096) == 640  # 21 M positions, one slab
    assert kernels.funnel_tile_rows(16, 1024, 4) == 16
    rows = kernels.funnel_tile_rows(40000, 512, 4096)
    assert rows % 4096 == 0 and rows * 512 <= kernels.SENS_SCRATCH
    with pytest.raises(ValueError, match="replay"):
        kernels.funnel_tile_rows(5000, 512, 8192)


# ---------------------------------------------------------------------------
# The sampled-SA walk, resolve_pack through it, and the int64 index
# ---------------------------------------------------------------------------


def fm_index(gidx, dtype):
    """The genome's FMIndexTensors on the CPU in one index dtype."""
    from test_torch_sampled import arrays64

    if dtype == "int32":
        return tfm.FMIndexTensors.from_genome_index(gidx, "cpu")
    return tfm.FMIndexTensors.from_numpy(arrays64(gidx), "cpu")


def fm_ptrs(fm):
    """occ_cp, bwt_words, L2 and sa_samples of an FMIndexTensors, as the C
    entries take them, and primary."""
    return (ptr(fm.occ_cp.numpy()), ptr(fm.bwt_words.numpy()), ptr(fm.L2.numpy()),
            ptr(fm.sa_samples.numpy()), fm.primary)


@pytest.mark.parametrize("max_steps", [4096, 8])
@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_sa_walk_kernel_on_host_matches_plain(host_lib, shim_genome, dtype, max_steps):
    """Random rows and the rows at the edges (1, 31, 32, primary and its
    neighbours, seq_len), walks cut at max_steps 8 included."""
    from test_torch_sampled import walk_rows

    gidx, _ = shim_genome
    fm = fm_index(gidx, dtype)
    idt = np.int32 if dtype == "int32" else np.int64
    rows = walk_rows(gidx, 700).astype(idt)
    pos = np.full(len(rows), -7, idt)
    done = np.full(len(rows), 9, np.uint8)
    sfx = "" if dtype == "int32" else "_i64"
    rc = getattr(host_lib, "kart_sa_walk" + sfx)(*fm_ptrs(fm), ptr(rows), len(rows), max_steps,
                                                 ptr(pos), ptr(done), None)
    assert rc == 0
    want_pos, want_done = tfm.sa_walk_plain(fm, torch.from_numpy(rows), max_steps=max_steps)
    np.testing.assert_array_equal(pos, want_pos.numpy())
    np.testing.assert_array_equal(done.astype(bool), want_done.numpy())
    assert (~want_done).any() == (max_steps == 8)


# name: (B, S, H, has_ok, pack16, index dtype, max_steps, through the full SA)
RESOLVE_WALK_CASES = {
    "int32_pack16": (300, 6, 900, True, True, "int32", 4096, False),
    "int32_32bit_four_blocks": (1000, 9, 4000, False, False, "int32", 4096, False),
    "int32_cut_walks": (300, 6, 900, True, True, "int32", 8, False),
    "int64": (300, 9, 1200, False, False, "int64", 4096, False),
    "int64_cut_walks": (300, 9, 1200, True, False, "int64", 8, False),
    "int64_full_sa": (300, 9, 1200, True, False, "int64", 4096, True),
    "int64_budget_zero": (40, 6, 0, False, False, "int64", 4096, False),
}


@pytest.mark.parametrize("name", list(RESOLVE_WALK_CASES))
def test_resolve_pack_sampled_and_int64_on_host_matches_plain(host_lib, shim_genome, name):
    """resolve_pack through the sampled SA (int32: the positions in the one
    stream; int64: the counts and meta words, and the positions in their own
    array) and through an int64 full SA, as kernels.resolve_pack makes the
    calls: the rows pass, the walk of sa_walk.cu, then the flag and emit
    passes; walks cut at max_steps 8 flag their reads."""
    B, S, H, has_ok, pack16, dtype, max_steps, full = RESOLVE_WALK_CASES[name]
    gidx, _ = shim_genome
    fm = fm_index(gidx, dtype)
    idt = np.int32 if dtype == "int32" else np.int64
    rng = np.random.default_rng(B + H + max_steps)
    packed = np.ascontiguousarray(packed_seeds(rng, B, S, gidx.seq_len, has_ok, 0.9), idt)
    wide = dtype == "int64"
    n = B + H if wide else ((B // 2 + H // 2 + H) if pack16 else (B + 2 * H))
    out = np.full(n, -7, np.int32)
    gpos = np.full(H, -7, np.int64)
    read_end, cnts = np.full(B, -7, np.int32), np.full(B, -7, np.int32)
    state = np.full(host_lib.kart_resolve_scan_words(B), -1, np.int64)
    sa = np.ascontiguousarray(gidx.sa_full, idt) if full else None
    # scratch arrives as garbage; an int32 stream's positions are its last H words
    rows, slot_read = np.full(H, -5, idt), np.full(H, -5, np.int32)
    done = np.full(H, 7, np.uint8)
    g = gpos if wide else out[n - H:]
    head = (ptr(packed), B, int(has_ok), S)
    sfx = "_i64" if wide else ""
    rc = getattr(host_lib, "kart_resolve_rows" + sfx)(
        *head, None if sa is None else ptr(sa), H, ptr(read_end), ptr(cnts), ptr(state),
        ptr(rows), ptr(slot_read), g.ctypes.data, None)
    assert rc == 0
    if not full and H:
        rc = getattr(host_lib, "kart_sa_walk" + sfx)(*fm_ptrs(fm), ptr(rows), H, max_steps,
                                                     g.ctypes.data, ptr(done), None)
        assert rc == 0
    tail = (ptr(read_end), ptr(cnts), ptr(slot_read), None if full else ptr(done), g.ctypes.data,
            ptr(out), None)
    if wide:
        rc = host_lib.kart_resolve_finish_i64(*head, H, *tail)
    else:
        rc = host_lib.kart_resolve_finish(*head, H, int(pack16), *tail)
    assert rc == 0
    want = tres.resolve_pack_plain(None if sa is None else torch.from_numpy(sa),
                                   torch.from_numpy(packed), max_seeds=S, has_ok=has_ok,
                                   occ_budget=H, pack16=pack16, fm=fm, max_steps=max_steps)
    if wide:
        for g, w in zip((out[:B], out[B:], gpos), want):
            np.testing.assert_array_equal(g, w.numpy())
    else:
        np.testing.assert_array_equal(out, want.numpy())
    c = (want[0] if wide else torch.from_numpy(tpack.unpack_stream(want.numpy(), B, H,
                                                                   pack16)[0])).numpy()
    ok, tot, offs = tres.decode_resolved_counts(c)
    fits = (offs[1:] <= H) & (tot > 0)
    if max_steps == 8:  # reads that fit and were ok are flagged by their cut walks
        assert (fits & ~ok).sum() > (fits & ~ok & ~packed_ok(packed, has_ok)).sum() + 5
    elif H:
        assert (fits & ok).sum() > 50


def packed_ok(packed, has_ok):
    return packed[:, 1] != 0 if has_ok else np.ones(len(packed), bool)


@pytest.mark.parametrize("name", ["ragged_127", "edges", "seeds_dropped"])
def test_fm_seed_scan_kernel_on_host_int64_matches_plain(host_lib, shim_genome, name):
    """The int64 instance of the FastMode stepper: its packed int64 rows
    equal the plain version's on the int64 index, and the int32 result
    widened."""
    gidx, _ = shim_genome
    B, l_max, ms = FM_CASES[name]
    ms = ms or l_max // (MIN_SEED + 1) + 1
    if name == "edges":
        reads, rlens = fm_edge_reads(gidx, l_max)
    else:
        reads, rlens = make_reads(gidx, B, l_max, seed=B)
        if name == "seeds_dropped":
            reads[:, 14::15] = (reads[:, 14::15] + 1) % 4
    B = len(reads)
    fm = fm_index(gidx, "int64")
    want = tfm.seed_scan_plain(fm, torch.from_numpy(reads), torch.from_numpy(rlens), MIN_SEED,
                               max_seeds=ms, l_max=l_max).numpy()
    out = np.full((B, 1 + 4 * ms), -7, np.int64)
    rc = host_lib.kart_fm_seed_scan_i64(ptr(fm.occ_cp.numpy()), ptr(fm.bwt_words.numpy()),
                                        ptr(fm.L2.numpy()), fm.primary, ptr(reads), ptr(rlens), B,
                                        l_max, MIN_SEED, ms, ptr(out), None)
    assert rc == 0
    np.testing.assert_array_equal(out, want)
    narrow = tfm.seed_scan_plain(fm_index(gidx, "int32"), torch.from_numpy(reads),
                                 torch.from_numpy(rlens), MIN_SEED, max_seeds=ms, l_max=l_max)
    np.testing.assert_array_equal(out, narrow.numpy().astype(np.int64))
    assert want[:, 0].sum() >= 6


@pytest.mark.parametrize("name", ["ragged", "trip_cut", "tiles"])
def test_fm_sensitive_scan_kernel_on_host_int64_matches_plain(host_lib, shim_genome, name):
    """The int64 instances of the SensitiveMode extension and chase (the
    outcomes as longlong2 entries of the window)."""
    from test_torch_fm_search import _sensitive_reads

    gidx, _ = shim_genome
    l_max, ms, tile = FM_SENS_CASES[name]
    reads, rlens, l_max, ms = _sensitive_reads(gidx, "long" if name == "tiles" else name)
    fm = fm_index(gidx, "int64")
    want = tfm.sensitive_scan_plain(fm, torch.from_numpy(reads), torch.from_numpy(rlens),
                                    MIN_SEED, max_seeds=ms, l_max=l_max).numpy()
    B, width = reads.shape
    cap = (tile or B) * width
    ext = np.full((cap, 2), -3, np.int64)
    out = np.full((B, 1 + 4 * ms), -7, np.int64)
    rc = host_lib.kart_fm_sensitive_scan_i64(
        ptr(fm.occ_cp.numpy()), ptr(fm.bwt_words.numpy()), ptr(fm.L2.numpy()), fm.primary,
        ptr(reads), ptr(rlens), B, width, MIN_SEED, ms, 31 * (l_max // MIN_SEED + 2), ptr(ext),
        cap, ptr(out), None)
    assert rc == 0
    np.testing.assert_array_equal(out, want)
    assert want[:, 0].sum() >= 10


# ---------------------------------------------------------------------------
# The python backend's device clustering and paired-end mating
# ---------------------------------------------------------------------------


def host_cluster(lib, keys, pd, gp, ln, n, thr0, max_gaps):
    """csrc/cluster.cu through the host shim; its outputs start as garbage."""
    B, S = pd.shape
    cid = np.full((B, S), -7, np.int32)
    accept = np.full((B, S), 9, np.uint8)
    scores = np.full((B, S), -7, np.int32)
    args = [np.ascontiguousarray(a, dtype=np.int32) for a in (keys, pd, gp, ln, n, thr0)]
    rc = lib.kart_cluster_illumina(ptr(args[0]), len(keys), *(ptr(a) for a in args[1:]), max_gaps,
                                   B, S, ptr(cid), ptr(accept), ptr(scores), None)
    assert rc == 0
    return cid, accept.view(bool), scores


@pytest.fixture(scope="module")
def cluster_genome(workdir):
    from test_torch_cluster import three_chromosomes

    return three_chromosomes(workdir)


@pytest.mark.parametrize("name", ["random_200", "wide_chunks", "no_seeds", "negative_posdiffs",
                                  "chromosome_keys", "gap_edges", "one_slot", "threshold_rises",
                                  "many_keys"])
def test_cluster_kernel_on_host_matches_plain(host_lib, cluster_genome, name):
    """test_torch_cluster's batches (which hold the plain version against
    kart_tpu), and one with 9,000 chromosome keys, many seeds on a key."""
    from test_torch_cluster import MAX_GAPS, cluster_cases

    from kart_tpu_torch.ops import cluster as tcl

    gidx, _ = cluster_genome
    if name == "many_keys":
        rng = np.random.default_rng(31)
        keys = np.sort(rng.choice(10**7, 9000, replace=False)).astype(np.int32)
        B, S = 60, 40
        pd = np.sort(rng.integers(-3, 10**7, (B, S)), axis=1).astype(np.int32)
        pd[:, 1::2] = pd[:, ::2] + rng.integers(0, 8, (B, S // 2))
        gp = (pd + rng.integers(0, 100, (B, S))).astype(np.int32)
        gp[:, 5] = keys[rng.integers(0, 9000, B)]  # seeds on a key
        args = (keys, pd, gp, rng.integers(13, 40, (B, S)).astype(np.int32),
                rng.integers(0, S + 1, B).astype(np.int32), np.full(B, 20, np.int32))
    else:
        args = cluster_cases(gidx.chr_map[0], gidx.two_genome_size)[name]
    want = tcl.cluster_illumina_plain(*(torch.from_numpy(a) for a in args), MAX_GAPS,
                                      max_seeds=args[1].shape[1])
    got = host_cluster(host_lib, *args, MAX_GAPS)
    for g, w, what in zip(got, want, ("cluster_id", "accept", "scores")):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=what)
    if name == "many_keys":
        assert (want[0].max(dim=1).values >= 3).sum() > 30


def host_pair(lib, s1, d1, s2, d2, est):
    """csrc/pairing.cu through the host shim; its outputs start as garbage."""
    P, C1 = s1.shape
    C2 = s2.shape[1]
    p1 = np.full((P, C1), -7, np.int32)
    p2 = np.full((P, C2), -7, np.int32)
    flag = np.full(P, 9, np.uint8)
    rc = lib.kart_pair_candidates(ptr(s1), ptr(d1), ptr(s2), ptr(d2), est, P, C1, C2, ptr(p1),
                                  ptr(p2), ptr(flag), None)
    assert rc == 0
    return p1, p2, flag.view(bool)


@pytest.mark.parametrize("name", ["random", "wide", "tie_and_steal", "distance_edges", "empty",
                                  "past_shared_memory"])
def test_pair_kernel_on_host_matches_plain(host_lib, name):
    """test_torch_pairing's batches (which hold the plain version against
    kart_tpu), and pairs of 40 + 3,100 slots, more than a block's shared
    memory would hold for its four pairs."""
    from test_torch_pairing import pairing_cases

    from kart_tpu_torch.ops import pairing as tpa

    if name == "past_shared_memory":
        rng = np.random.default_rng(8)
        P, C1, C2 = 5, 40, 3100
        args = (rng.integers(0, 9, (P, C1)).astype(np.int32),
                rng.integers(0, 5000, (P, C1)).astype(np.int32),
                rng.integers(0, 10**5, (P, C2)).astype(np.int32),
                rng.integers(0, 5000, (P, C2)).astype(np.int32), 60)
    else:
        args = pairing_cases()[name]
    want = tpa.pair_candidates_plain(*(torch.from_numpy(a) for a in args[:4]), args[4])
    got = host_pair(host_lib, *args)
    for g, w, what in zip(got, want, ("paired1", "paired2", "pairing")):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=what)
    if name == "past_shared_memory":
        assert want[2].all() and (want[0] >= 0).sum() > 50


# ---------------------------------------------------------------------------
# The sharded index through its shard table: the resident scan and walk
# (csrc/fm_seed_scan.cu, csrc/sa_walk.cu), and csrc/sharded_fm.cu's G1 occ4,
# G2 scan step, G3 walk step and G4 gather; each shard's slab on the CPU
# ---------------------------------------------------------------------------


def sharded_index(gidx, dtype, n, sa_mode="full"):
    """The index in n slabs on the CPU, in one index dtype."""
    from kart_tpu_torch.parallel import sharded_index as tsi

    g = gidx if dtype == "int32" else tsi.index_int64(gidx)
    return tsi.build_sharded_fm(g, ["cpu"] * n, sa_mode)


def tnp(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.numpy())


def shard_splits(sfm):
    """The ways of grouping the shards that the table kernels are run with:
    every shard alone, the shards in two groups (the first half, with shard
    0, and the rest), and all of them in one table."""
    sh = sfm.shards
    half = (len(sh) + 1) // 2
    out = [[[s] for s in sh], [sh]]
    if len(sh) > 1:
        out.insert(1, [sh[:half], sh[half:]])
    return out


def host_occ4(lib, sfm, shards, k, sfx):
    """G1 through the host shim with the table of `shards`; its output
    starts as garbage."""
    from kart_tpu_torch.parallel import sharded_index as tsi

    kk = tnp(k)
    out = np.full((len(kk), 4), -7, kk.dtype)
    table = tsi.shard_table(sfm, shards)
    rc = getattr(lib, "kart_sharded_occ4" + sfx)(
        table.data_ptr(), table.shape[0], sfm.nb_local, sfm.primary, ptr(kk), len(kk), ptr(out),
        None)
    assert rc == 0
    return torch.from_numpy(out)


def host_fused_step(lib, sfm, shards, parts, k, p, codes_t, rlens, ms, state, out, sfx):
    """The fused step through the host shim: occ4 of the rows k from the
    table of `shards`, plus `parts` (read through an array of their
    pointers), then the step; its outputs start as garbage.  Returns the
    state and the next rows; out is written in place."""
    from kart_tpu_torch.parallel import sharded_index as tsi

    ist, tst = (tnp(x) for x in state)
    B = ist.shape[1]
    ist_out, tst_out = np.full_like(ist, -7), np.full_like(tst, -7)
    k_next = np.full(2 * B, -7, tst.dtype)
    part_arrays = [tnp(x) for x in parts]
    ptrs = np.array([ptr(a) for a in part_arrays], np.uint64)
    table = tsi.shard_table(sfm, shards)
    rc = getattr(lib, "kart_sharded_fused_step" + sfx)(
        table.data_ptr(), table.shape[0], sfm.nb_local, ptr(ptrs) if len(ptrs) else None,
        len(ptrs), ptr(tnp(k)), ptr(tnp(codes_t)), ptr(tnp(rlens)), ptr(tnp(sfm.L2)), sfm.primary,
        B, codes_t.shape[0], p, MIN_SEED, ms, ptr(ist), ptr(tst), ptr(ist_out), ptr(tst_out),
        ptr(out.numpy()), ptr(k_next), None)
    assert rc == 0
    return (torch.from_numpy(ist_out), torch.from_numpy(tst_out)), torch.from_numpy(k_next)


def host_inv_psi(lib, sfm, shards, k, add, sfx):
    from kart_tpu_torch.parallel import sharded_index as tsi

    kk = tnp(k)
    out = np.full(len(kk), -7, kk.dtype)
    table = tsi.shard_table(sfm, shards)
    rc = getattr(lib, "kart_sharded_inv_psi" + sfx)(
        table.data_ptr(), table.shape[0], sfm.nb_local, ptr(tnp(sfm.L2)), sfm.primary, ptr(kk),
        len(kk), ptr(out), None if add is None else ptr(add), None)
    assert rc == 0
    return torch.from_numpy(out)


def host_gather(lib, sfm, shards, rows, shift, sfx):
    """G4 through the host shim with the table of `shards`: the full SA
    (shift 0) or the samples (shift 5); its output starts as garbage."""
    from kart_tpu_torch.parallel import sharded_index as tsi

    r = tnp(rows)
    out = np.full(len(r), -7, r.dtype)
    table = tsi.shard_table(sfm, shards)
    rc = getattr(lib, "kart_sharded_gather" + sfx)(
        table.data_ptr(), table.shape[0], sfm.ns_local if shift == 0 else sfm.nsamp_local, ptr(r),
        len(r), shift, ptr(out), None)
    assert rc == 0
    return torch.from_numpy(out)


SHARD_CASES = [("int32", 1), ("int32", 3), ("int64", 3), ("int64", 8)]


@pytest.mark.parametrize("dtype, n", SHARD_CASES)
def test_sharded_occ4_kernel_on_host_matches_plain(host_lib, shim_genome, dtype, n):
    """G1 through the shard table, of rows around `primary`, 0, seq_len and
    at random: each shard alone, the shards in two groups and all in one
    table, every launch equal to the owner-select plain version of its
    shards, and each grouping's sum to the replicated index's occ4."""
    from test_torch_sampled import walk_rows

    from kart_tpu_torch.parallel import sharded_index as tsi

    gidx, _ = shim_genome
    sfm = sharded_index(gidx, dtype, n)
    sfx = "" if dtype == "int32" else "_i64"
    k = torch.from_numpy(np.concatenate([[0], walk_rows(gidx, 500)]).astype(
        np.int32 if dtype == "int32" else np.int64))
    want = tfm.occ4(fm_index(gidx, dtype), k)
    for groups in shard_splits(sfm):
        parts = []
        for shards in groups:
            got = host_occ4(host_lib, sfm, shards, k, sfx)
            assert torch.equal(got, tsi.table_occ4_plain(sfm, shards, k))
            parts.append(got)
        assert torch.equal(tsi.combine(parts, sfm.device), want)


@pytest.mark.parametrize("dtype, n", SHARD_CASES)
def test_sharded_scan_step_kernel_on_host_matches_plain(host_lib, shim_genome, dtype, n):
    """The cross-device scan through the host shim, the shards in two groups
    (one where there is one shard): each step a G1 launch of the second
    group into a part, and the fused step on the first (its own lookup, the
    part, the step), every step's state, rows and seed rows equal to the
    plain fused step's and to seed_scan_step_plain's on the summed counts,
    and the packed seeds to the replicated scan's: the stepper's edge reads
    (pad, short and all-N lanes, Ns, the texts around `primary`), seeds past
    max_seeds dropped."""
    from kart_tpu_torch.parallel import sharded_index as tsi

    gidx, _ = shim_genome
    sfm = sharded_index(gidx, dtype, n)
    sfx = "" if dtype == "int32" else "_i64"
    groups = shard_splits(sfm)[-2]
    reads, rlens = sharded_scan_reads(gidx, 80)
    B, L = reads.shape
    ms = 1  # fewer slots than some reads' seeds
    codes_t = reads.t().contiguous()
    state, out, k = tfm.seed_scan_state(B, ms, sfm.index_dtype, "cpu")
    for p in range(L + 1):
        parts = [host_occ4(host_lib, sfm, g, k, sfx) for g in groups[1:]]
        cnt = tsi.combine([tsi.table_occ4_plain(sfm, groups[0], k)] + parts, sfm.device)
        want_out, fused_out = out.clone(), out.clone()
        want_state, want_k = tfm.seed_scan_step_plain(p, cnt, codes_t, rlens, sfm.L2, sfm.primary,
                                                      MIN_SEED, ms, state, want_out)
        fused_state, fused_k = tsi.fused_step_plain(sfm, groups[0], k, parts, p, codes_t, rlens,
                                                    MIN_SEED, ms, state, fused_out)
        got_state, got_k = host_fused_step(host_lib, sfm, groups[0], parts, k, p, codes_t, rlens,
                                           ms, state, out, sfx)
        for got, want, fused, nm in ((got_state[0], want_state[0], fused_state[0], "ist"),
                                     (got_state[1], want_state[1], fused_state[1], "tst"),
                                     (got_k, want_k, fused_k, "rows"),
                                     (out, want_out, fused_out, "seeds")):
            np.testing.assert_array_equal(got.numpy(), want.numpy(), err_msg=f"{nm} at {p}")
            np.testing.assert_array_equal(fused.numpy(), want.numpy(), err_msg=f"{nm} at {p}")
        state, k = got_state, got_k
    want = tfm.seed_scan_plain(fm_index(gidx, dtype), reads, rlens, MIN_SEED, max_seeds=ms,
                               l_max=L)
    assert torch.equal(out, want)
    assert (want[:, 0] > ms).any() and (want[:, 0] == 0).any()


def host_resident_scan(lib, sfm, reads, rlens, *, ms, sfx):
    """The resident scan (kart_sharded_seed_scan) through the host shim,
    every shard in the table; its output starts as garbage."""
    from kart_tpu_torch.parallel import sharded_index as tsi

    B, L = reads.shape
    out = np.full((B, 1 + 4 * ms), -7, tnp(sfm.L2).dtype)
    table = tsi.shard_table(sfm, sfm.shards)
    rc = getattr(lib, "kart_sharded_seed_scan" + sfx)(
        table.data_ptr(), table.shape[0], sfm.nb_local, ptr(tnp(sfm.L2)), sfm.primary,
        ptr(tnp(reads)), ptr(tnp(rlens)), B, L, MIN_SEED, ms, ptr(out), None)
    assert rc == 0
    return torch.from_numpy(out)


@pytest.mark.parametrize("ms", [1, 6])
@pytest.mark.parametrize("dtype, n", SHARD_CASES)
def test_sharded_seed_scan_kernel_on_host_matches_plain(host_lib, shim_genome, dtype, n, ms):
    """The resident scan, fm_seed_scan.cu's loop through the shard table, on
    the stepper's edge reads and 40 reads of the genome: equal to its plain
    version (the owner-select occ4 loop), to the cross-device scan over two
    groups and to the replicated scan; seeds past max_seeds dropped (1
    slot)."""
    from kart_tpu_torch.parallel import sharded_index as tsi

    gidx, _ = shim_genome
    sfm = sharded_index(gidx, dtype, n)
    sfx = "" if dtype == "int32" else "_i64"
    reads, rlens = sharded_scan_reads(gidx, 80)
    kw = dict(max_seeds=ms, l_max=reads.shape[1])
    got = host_resident_scan(host_lib, sfm, reads, rlens, ms=ms, sfx=sfx)
    assert torch.equal(got, tsi.resident_seed_scan_plain(sfm, reads, rlens, MIN_SEED, **kw))
    assert torch.equal(got, tsi._stepwise_seed_scan(sfm, reads, rlens, MIN_SEED, **kw,
                                                    groups=shard_splits(sfm)[-2]))
    assert torch.equal(got, tfm.seed_scan_plain(fm_index(gidx, dtype), reads, rlens, MIN_SEED,
                                                **kw))
    assert (got[:, 0] > 0).sum() > 30


def sharded_scan_reads(gidx, l_max):
    """fm_edge_reads' reads (pads, short and all-N reads, Ns, the texts
    around `primary`) and 40 reads of the genome, every third with a
    mismatch."""
    rng = np.random.default_rng(21)
    starts = rng.integers(0, gidx.two_genome_size - l_max, 40)
    reads = gidx.ref_codes[starts[:, None] + np.arange(l_max)].astype(np.int32)
    reads[::3, 20] = (reads[::3, 20] + 1) % 4
    edges, edge_lens = fm_edge_reads(gidx, l_max)
    return (torch.from_numpy(np.concatenate([edges, reads])),
            torch.from_numpy(np.concatenate([edge_lens, np.full(40, l_max, np.int32)])))


@pytest.fixture(scope="module")
def limit_genome(workdir):
    """Random sequence with 50 copies of a 40-base element and 51 copies of
    another, each copy between two As: a read of N, the element, then C
    ends a seed of exactly 50 or 51 occurrences."""
    d = workdir / "torch_host_shim_limit"
    d.mkdir(exist_ok=True)
    rng = np.random.default_rng(50)
    elems = [_ACGT[rng.integers(0, 4, 40)] for _ in range(2)]
    copies = [0] * 50 + [1] * 51
    rng.shuffle(copies)
    parts = [_ACGT[rng.integers(0, 4, 300)]]
    for e in copies:
        parts += [np.frombuffer(b"A", np.uint8), elems[e], np.frombuffer(b"A", np.uint8),
                  _ACGT[rng.integers(0, 4, 200)]]
    seq = np.concatenate(parts).tobytes().decode()
    fa = d / "g.fa"
    fa.write_text(">c1\n" + "\n".join(seq[j : j + 70] for j in range(0, len(seq), 70)) + "\n")
    build_index(str(fa), str(d / "idx"), verbose=False)
    return load_index(str(d / "idx")), elems


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_sharded_scan_step_kernel_on_host_occurrence_limit(host_lib, limit_genome, dtype):
    """Seeds of exactly 50 occurrences are recorded and of 51 are not: the
    cross-device scan (3 shards in two groups) and the resident scan
    through the host shim equal the plain scan, which has both kinds of
    seed."""
    from kart_tpu_torch.index.format import NT4_TABLE
    from kart_tpu_torch.parallel import sharded_index as tsi

    gidx, elems = limit_genome
    sfm = sharded_index(gidx, dtype, 3)
    sfx = "" if dtype == "int32" else "_i64"
    L, ms = 64, 4
    reads = np.full((6, L), 4, np.int32)
    rng = np.random.default_rng(4)
    for i in range(6):
        reads[i, 1:41] = NT4_TABLE[elems[i % 2]]
        reads[i, 41] = 1  # C: no copy is followed by it
        reads[i, 42:] = rng.integers(0, 4, L - 42)
    reads, rlens = torch.from_numpy(reads), torch.full((6,), L, dtype=torch.int32)

    groups = shard_splits(sfm)[1]
    codes_t = reads.t().contiguous()
    state, got, k = tfm.seed_scan_state(reads.shape[0], ms, sfm.index_dtype, "cpu")
    for p in range(L + 1):
        parts = [host_occ4(host_lib, sfm, g, k, sfx) for g in groups[1:]]
        state, k = host_fused_step(host_lib, sfm, groups[0], parts, k, p, codes_t, rlens, ms,
                                   state, got, sfx)
    want = tfm.seed_scan_plain(fm_index(gidx, dtype), reads, rlens, MIN_SEED, max_seeds=ms,
                               l_max=L)
    assert torch.equal(got, want)
    assert torch.equal(host_resident_scan(host_lib, sfm, reads, rlens, ms=ms, sfx=sfx), want)
    o = tfm.unpack_seed_scan(want, ms)
    first = o["freq"][:, 0].numpy()
    assert (o["slen"][0::2, 0] == 40).all() and (first[0::2] == 50).all()
    assert not (o["freq"][1::2] == 51).any()


@pytest.mark.parametrize("max_steps", [4096, 8])
@pytest.mark.parametrize("dtype, n", SHARD_CASES)
def test_sharded_walk_kernels_on_host_match_plain(host_lib, shim_genome, dtype, n, max_steps):
    """The cross-device walk through the host shim, the shards in two
    groups: G3 steps (each group's output equal to the plain version's, the
    step counts in the first group's launch) until every row is at a sample
    or max_steps, then G4 on the sampled SA's slabs; (pos, done) equal to the
    plain sharded walk's and to the replicated sa_walk's, walks cut at 8
    steps included."""
    from test_torch_sampled import walk_rows

    from kart_tpu_torch.parallel import sharded_index as tsi

    gidx, _ = shim_genome
    sfm = sharded_index(gidx, dtype, n, "sampled")
    sfx = "" if dtype == "int32" else "_i64"
    groups = shard_splits(sfm)[-2]
    k = torch.from_numpy(walk_rows(gidx, 300).astype(np.int32 if dtype == "int32" else np.int64))
    rows = k.clone()
    add = np.zeros(len(k), np.int32)
    for _ in range(max_steps):
        if not bool(((k & 31) != 0).any()):
            break
        want_add = torch.from_numpy(add.copy())
        parts = []
        for i, g in enumerate(groups):
            got = host_inv_psi(host_lib, sfm, g, k, add if i == 0 else None, sfx)
            want = tsi.table_inv_psi_plain(sfm, g, k, want_add if i == 0 else None)
            assert torch.equal(got, want)
            parts.append(got)
        np.testing.assert_array_equal(add, want_add.numpy())
        k = tsi.combine(parts, sfm.device)
    samp = []
    for g in groups:
        samp.append(host_gather(host_lib, sfm, g, k, 5, sfx))
        assert torch.equal(samp[-1], tsi.table_gather_plain(sfm, g, k, 5))
    samp = tsi.combine(samp, sfm.device)
    pos, done = torch.from_numpy(add).to(k.dtype) + samp, (k & 31) == 0
    for want in (tsi.sharded_sa_walk(sfm, rows, max_steps=max_steps),
                 tsi._stepwise_sa_walk(sfm, rows, max_steps=max_steps, groups=groups),
                 tfm.sa_walk_plain(fm_index(gidx, dtype), rows, max_steps=max_steps)):
        for a, b in zip((pos, done), want):
            assert torch.equal(a, b)
    assert bool(done.all()) == (max_steps == 4096)


@pytest.mark.parametrize("max_steps", [4096, 8])
@pytest.mark.parametrize("dtype, n", SHARD_CASES)
def test_sharded_sa_walk_kernel_on_host_matches_plain(host_lib, shim_genome, dtype, n, max_steps):
    """The resident walk, sa_walk.cu's loop through the shard table with the
    sample read from its owner's slab: (pos, done) of rows at and around
    samples, 0 and `primary`, equal to its plain version's and to the
    replicated sa_walk's, whole and cut at 8 steps."""
    from test_torch_sampled import walk_rows

    from kart_tpu_torch.parallel import sharded_index as tsi

    gidx, _ = shim_genome
    sfm = sharded_index(gidx, dtype, n, "sampled")
    sfx = "" if dtype == "int32" else "_i64"
    p = int(gidx.primary)
    rows = np.concatenate([[0, 32, p - 1, p, p + 1, int(gidx.seq_len)], walk_rows(gidx, 300)])
    rows = torch.from_numpy(rows.astype(np.int32 if dtype == "int32" else np.int64))
    pos = np.full(len(rows), -7, tnp(rows).dtype)
    done = np.full(len(rows), 7, np.uint8)
    table = tsi.shard_table(sfm, sfm.shards)
    rc = getattr(host_lib, "kart_sharded_sa_walk" + sfx)(
        table.data_ptr(), table.shape[0], sfm.nb_local, sfm.nsamp_local, ptr(tnp(sfm.L2)),
        sfm.primary, ptr(tnp(rows)), len(rows), max_steps, ptr(pos), ptr(done), None)
    assert rc == 0
    got = (torch.from_numpy(pos), torch.from_numpy(done.astype(bool)))
    assert set(np.unique(done)) <= {0, 1}
    for want in (tsi.resident_sa_walk_plain(sfm, rows, max_steps=max_steps),
                 tfm.sa_walk_plain(fm_index(gidx, dtype), rows, max_steps=max_steps)):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert bool(got[1].all()) == (max_steps == 4096)


@pytest.mark.parametrize("dtype, n", SHARD_CASES)
def test_sharded_gather_kernel_on_host_matches_plain(host_lib, shim_genome, dtype, n):
    """G4 through the shard table on the full SA's slabs (the last one
    padded) and on the samples', each shard alone, in two groups and all in
    one table: each launch equal to the plain composition of its shards'
    masked gathers, and the groups' sum to sa_full[rows] and
    sa_samples[rows >> 5]."""
    from test_torch_sampled import walk_rows

    from kart_tpu_torch.parallel import sharded_index as tsi

    gidx, _ = shim_genome
    sfm = sharded_index(gidx, dtype, n)
    sfx = "" if dtype == "int32" else "_i64"
    rows = torch.from_numpy(np.concatenate([[0, int(gidx.seq_len)], walk_rows(gidx, 500)]).astype(
        np.int32 if dtype == "int32" else np.int64))
    samples = np.asarray(gidx.device_arrays["sa_samples"])
    for shift, want in ((0, gidx.sa_full[rows.numpy()]), (5, samples[rows.numpy() >> 5])):
        for groups in shard_splits(sfm):
            parts = []
            for g in groups:
                got = host_gather(host_lib, sfm, g, rows, shift, sfx)
                assert torch.equal(got, tsi.table_gather_plain(sfm, g, rows, shift))
                parts.append(got)
            np.testing.assert_array_equal(tsi.combine(parts, sfm.device).numpy(), want)
