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
    arrays = dict(occ_cp=np.zeros(4), bwt_words=np.zeros(8, np.uint32), sa_samples=np.zeros(1),
                  L2=np.zeros(5), primary=0, seq_len=2**31)
    with pytest.raises(NotImplementedError, match="item 8"):
        torch_fm.FMIndexTensors.from_numpy(arrays, "cpu")


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
