"""The port's FM-index tensors and FastMode seeding scan
(kart_tpu_torch.ops.fm_search) against kart_tpu's JAX functions on the same
numpy inputs.  All outputs are integers: every comparison is exact."""

import jax
import numpy as np
import pytest
import torch

from kart_tpu.index import build_index, load_index
from kart_tpu.ops import fm_search as jax_fm
from kart_tpu_torch import kernels
from kart_tpu_torch.ops import fm_search as torch_fm

from conftest import make_genome
from test_fm_kernels import simulate_reads

torch.set_num_threads(1)

_FIELDS = ("occ_cp", "bwt_words", "sa_samples", "L2", "primary", "seq_len", "sa_full")


@pytest.fixture(scope="module")
def index(workdir):
    rng = np.random.default_rng(5)
    fa = workdir / "torch_fm.fa"
    fa.write_text(make_genome(rng, [20000], n_runs=0))
    prefix = workdir / "torch_fm_idx"
    build_index(str(fa), str(prefix), verbose=False)
    gidx = load_index(str(prefix))
    return gidx, jax_fm.FMIndexArrays.from_genome_index(gidx)


def test_from_numpy_equals_from_genome_index(index):
    gidx, jfm = index
    a = torch_fm.FMIndexTensors.from_numpy({f: np.asarray(getattr(jfm, f)) for f in _FIELDS}, "cpu")
    b = torch_fm.FMIndexTensors.from_genome_index(gidx, "cpu")
    for f in ("occ_cp", "bwt_words", "sa_samples", "L2", "sa_full"):
        ta, tb = getattr(a, f), getattr(b, f)
        assert ta.dtype == tb.dtype == torch.int32, f
        assert torch.equal(ta, tb), f
        np.testing.assert_array_equal(
            ta.numpy(), np.asarray(getattr(jfm, f)).reshape(-1).view(np.int32), err_msg=f
        )
    assert a.primary == b.primary == int(jfm.primary)
    assert a.seq_len == b.seq_len == int(jfm.seq_len)


def test_int64_index_not_ported():
    """An index of 2**31 text bases, once refused, is now taken in int64:
    from_numpy keeps the arrays' index dtype (the BWT words stay int32
    bits)."""
    arrays = dict(occ_cp=np.zeros(4, np.int64), bwt_words=np.zeros(8, np.uint32),
                  sa_samples=np.zeros(1, np.int64), L2=np.zeros(5, np.int64), primary=0,
                  seq_len=2**31)
    fm = torch_fm.FMIndexTensors.from_numpy(arrays, "cpu")
    assert fm.index_dtype == torch.int64 and fm.seq_len == 2**31
    assert fm.occ_cp.dtype == fm.sa_samples.dtype == torch.int64
    assert fm.bwt_words.dtype == torch.int32


def test_occ4_matches_jax(index):
    gidx, jfm = index
    tfm = torch_fm.FMIndexTensors.from_genome_index(gidx, "cpu")
    rng = np.random.default_rng(0)
    ks = rng.integers(0, gidx.seq_len + 1, size=200).astype(np.int32)
    ks[:3] = [0, gidx.primary, gidx.seq_len]
    want = np.asarray(jax.vmap(lambda k: jax_fm.occ4(jfm, k))(ks))
    got = torch_fm.occ4(tfm, torch.from_numpy(ks))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _reads(gidx, case):
    """(reads, rlens, l_max, max_seeds) for one seeding case."""
    rng = np.random.default_rng(31)
    if case == "fixed":
        reads = simulate_reads(gidx, 32, 120)  # 2% subs, some ambiguous bases
        return reads, np.full(32, 120, np.int32), 120, 120 // 14 + 1
    if case == "dropped":  # more seeds than slots
        reads = simulate_reads(gidx, 32, 100, err=0.04, seed=9)
        return reads, np.full(32, 100, np.int32), 100, 2
    lens = np.array([40, 77, 100, 14, 0, 13, 99, 64], np.int32)
    reads = np.full((len(lens), 100), 4, np.int32)
    for i, L in enumerate(lens):
        p = rng.integers(0, gidx.two_genome_size - int(L) - 1)
        reads[i, :L] = gidx.ref_codes[p : p + L]
    reads[6, 30:33] = 4  # an N run inside a read
    return reads, lens, 100, 8


@pytest.mark.parametrize("case", ["fixed", "variable", "dropped"])
def test_seed_scan_matches_jax(index, case):
    gidx, jfm = index
    tfm = torch_fm.FMIndexTensors.from_genome_index(gidx, "cpu")
    reads, rlens, l_max, ms = _reads(gidx, case)
    want = np.asarray(
        jax_fm.seed_scan(jfm, reads, rlens, np.int32(13), max_seeds=ms, l_max=l_max)
    )
    got = torch_fm.seed_scan(
        tfm, torch.from_numpy(reads), torch.from_numpy(rlens), 13, max_seeds=ms, l_max=l_max
    )
    assert want.dtype == np.int32 and got.dtype == torch.int32
    assert got.shape == (len(reads), 1 + 4 * ms)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(want[:, 0].sum()) > 0
    if case == "dropped":
        assert (want[:, 0] > ms).any()  # n_seeds counts past the dropped slots


def test_kernel_wrapper_refuses_cpu_tensors(index):
    gidx, _ = index
    tfm = torch_fm.FMIndexTensors.from_genome_index(gidx, "cpu")
    reads = torch.full((2, 64), 4, dtype=torch.int32)
    before = kernels.fm_seed_scan.launches
    with pytest.raises(ValueError, match="cuda"):
        kernels.fm_seed_scan(tfm, reads, torch.zeros(2, dtype=torch.int32), 13,
                             max_seeds=5, l_max=64)
    assert kernels.fm_seed_scan.launches == before


def tandem_index(workdir, name):
    """A 11 kb genome with an array of 75 copies of a 5-base unit: a 30-base
    window inside it has more than 50 occurrences, so SensitiveMode fails
    seeds longer than MinSeed there and rewinds to start + MinSeed."""
    rng = np.random.default_rng(21)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    unit = np.frombuffer(b"ACGTT", np.uint8)
    seq = np.concatenate([acgt[rng.integers(0, 4, 8000)], np.tile(unit, 75),
                          acgt[rng.integers(0, 4, 2500)]]).tobytes().decode()
    d = workdir / name
    d.mkdir(exist_ok=True)
    (d / "g.fa").write_text(">t\n" + "\n".join(seq[j : j + 70] for j in range(0, len(seq), 70))
                            + "\n")
    build_index(str(d / "g.fa"), str(d / "idx"), verbose=False)
    return load_index(str(d / "idx"))


def tandem_reads(gidx, n=6, rlen=700):
    """Reads that run from random sequence into the tandem array and out."""
    rng = np.random.default_rng(8)
    reads = np.full((n, rlen), 4, np.int32)
    for i in range(n):
        p = 8000 - 150 + 20 * i
        r = gidx.ref_codes[p : p + rlen].astype(np.int32)
        m = rng.random(rlen) < 0.03
        r[m] = (r[m] + rng.integers(1, 4, int(m.sum()))) % 4
        reads[i] = r
    return reads, np.full(n, rlen, np.int32)


def test_sensitive_scan_rewind_matches_jax(workdir):
    """Seeds that fail on too many occurrences send the position back behind
    the scan (start + MinSeed < p): same seeds as kart_tpu."""
    gidx = tandem_index(workdir, "torch_fm_tandem")
    jfm = jax_fm.FMIndexArrays.from_genome_index(gidx)
    tfm = torch_fm.FMIndexTensors.from_genome_index(gidx, "cpu")
    reads, rlens = tandem_reads(gidx)
    ms = 700 // 13 + 2
    want = np.asarray(jax_fm.sensitive_scan(jfm, reads, rlens, np.int32(13), max_seeds=ms,
                                            l_max=700))
    got = torch_fm.sensitive_scan(tfm, torch.from_numpy(reads), torch.from_numpy(rlens), 13,
                                  max_seeds=ms, l_max=700)
    np.testing.assert_array_equal(got.numpy(), want)
    out = torch_fm.unpack_seed_scan(want, ms)
    # seeds before and after the array, and a stretch inside it with none:
    # its windows gave only failed seeds
    for i in range(len(reads)):
        rp = out["rpos"][i, : out["n_seeds"][i]]
        assert rp.min() < 100 and rp.max() > 550 and np.diff(rp).max() > 100, rp


def _sensitive_reads(gidx, case):
    """(reads, rlens, static l_max, max_seeds) for one SensitiveMode case."""
    from test_fm_kernels import _simulate_long_reads

    if case in ("long", "trip_cut", "dropped"):
        # the reads of test_sensitive_scan_matches_host: 220/300/410 bases at
        # 10% error, an ambiguous stretch, an all-random read
        enc = _simulate_long_reads(gidx, 12, [220, 300, 410])
        enc[3][50:55] = 4
        enc[7] = np.random.default_rng(1).integers(0, 4, size=len(enc[7])).astype(np.int32)
    else:  # pad lanes, reads around MinSeed, an all-N read, a clean read (the rewind case)
        rng = np.random.default_rng(2)
        enc = _simulate_long_reads(gidx, 5, [150, 260], err=0.12, seed=4)
        p = int(rng.integers(0, gidx.two_genome_size - 400))
        enc += [np.zeros(0, np.int32), gidx.ref_codes[p : p + 12].astype(np.int32),
                gidx.ref_codes[p : p + 13].astype(np.int32),
                gidx.ref_codes[p : p + 14].astype(np.int32), np.full(90, 4, np.int32),
                gidx.ref_codes[p : p + 300].astype(np.int32), np.zeros(0, np.int32)]
    width = max(len(e) for e in enc)
    reads = np.full((len(enc), width), 4, np.int32)
    rlens = np.zeros(len(enc), np.int32)
    for i, e in enumerate(enc):
        reads[i, : len(e)] = e
        rlens[i] = len(e)
    if case == "trip_cut":  # a static l_max far below the reads: max_trips = 31 * 3
        return reads, rlens, 13, width // 13 + 2
    if case == "dropped":
        return reads, rlens, width, 3
    return reads, rlens, width, width // 13 + 2


@pytest.mark.parametrize("case", ["long", "ragged", "trip_cut", "dropped"])
def test_sensitive_scan_matches_jax(index, case):
    gidx, jfm = index
    tfm = torch_fm.FMIndexTensors.from_genome_index(gidx, "cpu")
    reads, rlens, l_max, ms = _sensitive_reads(gidx, case)
    want = np.asarray(
        jax_fm.sensitive_scan(jfm, reads, rlens, np.int32(13), max_seeds=ms, l_max=l_max)
    )
    got = torch_fm.sensitive_scan(
        tfm, torch.from_numpy(reads), torch.from_numpy(rlens), 13, max_seeds=ms, l_max=l_max
    )
    assert want.dtype == np.int32 and got.dtype == torch.int32
    assert got.shape == (len(reads), 1 + 4 * ms)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(want[:, 0].sum()) > 0
    full = np.asarray(jax_fm.sensitive_scan(jfm, reads, rlens, np.int32(13),
                                            max_seeds=reads.shape[1] // 13 + 2,
                                            l_max=reads.shape[1]))
    if case == "trip_cut":  # the cut loses seeds that the full loop finds
        assert want[:, 0].sum() < full[:, 0].sum()
    elif case == "dropped":  # seeds past max_seeds are dropped and not counted
        assert (want[:, 0] == ms).any() and (full[:, 0] > ms).any()
    elif case == "ragged":
        assert (want[[5, 6, 7, 9, 11], 0] == 0).all() and want[10, 0] >= 8


def test_sensitive_kernel_wrapper_refuses_cpu_tensors(index):
    gidx, _ = index
    tfm = torch_fm.FMIndexTensors.from_genome_index(gidx, "cpu")
    reads = torch.full((2, 64), 4, dtype=torch.int32)
    before = kernels.fm_sensitive_scan.launches
    with pytest.raises(ValueError, match="cuda"):
        kernels.fm_sensitive_scan(tfm, reads, torch.zeros(2, dtype=torch.int32), 13,
                                  max_seeds=6, l_max=64)
    assert kernels.fm_sensitive_scan.launches == before
