"""The two redesigned CUDA kernels run on the CPU: `csrc/kmer_funnel.cu` and
`csrc/resolve_pack.cu` compiled as host C++ against
`tests/host_shim/cuda_shim.h` (threads as std::threads, the
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
from kart_tpu_torch.ops import kmer_seed as tks
from kart_tpu_torch.ops import pack as tpack
from kart_tpu_torch.ops import resolve as tres
from host_shim import translate
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
    translate.build(str(so), [os.path.join(CSRC, "kmer_funnel.cu"),
                              os.path.join(CSRC, "resolve_pack.cu")])
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.kart_kmer_funnel.argtypes = [p, p, p, p, i, p, p, p, i, p, i, i, i, i, i, i, i, i, p, p, p]
    lib.kart_kmer_funnel.restype = i
    lib.kart_kmer_funnel_cluster.restype = i
    lib.kart_resolve_pack.argtypes = [p, i, i, i, p, i, i, p, p, p, p, p]
    lib.kart_resolve_pack.restype = i
    lib.kart_resolve_scan_words.argtypes = [i]
    lib.kart_resolve_scan_words.restype = i
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


def host_funnel(lib, tb, words, amb_r, amb_p, rlens, *, l_max, hit_cap, slab_rows, hit_budget):
    B = words.shape[0]
    ms = l_max // (MIN_SEED + 1) + 1
    table_lo = np.ascontiguousarray(tb.table_lo_np, np.int32)
    sub_tbl = np.ascontiguousarray(tb.sub_tbl_np)
    sa = np.ascontiguousarray(tb.sa_full_np, np.int32)
    text = np.ascontiguousarray(tb.text_words_np())
    ambm = np.full((B, -(-l_max // 32)), -1, np.int32)  # scratch arrives as garbage
    out = np.full((B, 2 + 4 * ms), -7, np.int32)
    rc = lib.kart_kmer_funnel(ptr(table_lo), ptr(sub_tbl), ptr(sa), ptr(text), int(tb.seq_len),
                              ptr(words), ptr(amb_r), ptr(amb_p), len(amb_r), ptr(rlens), B, l_max,
                              MIN_SEED, ms, hit_cap, l_max // 10 + 4, slab_rows, hit_budget,
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
                                   ms, 16, 10, 32000, 2, ptr(ambm), ptr(out), None)
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
