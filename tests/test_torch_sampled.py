"""The port's sampled-SA resolution and int64 index against kart_tpu's JAX
functions on the same numpy inputs: `sa_walk` (with its cut walks at
max_steps), the FastMode and SensitiveMode steppers on an int64 index, and
the two FM `*_resolved_packed` entry points with sa_mode "sampled", int32
(with and without pack16) and int64 (the (cnts, meta, gpos) tuple).  The
int64 side of kart_tpu runs with jax_enable_x64 on, as its own
tests/test_fm_i64.py runs it, and off after each test.  Every comparison is
exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kart_tpu.index import build_index, load_index
from kart_tpu.ops import fm_search as jfm
from kart_tpu.ops import pack as jpack
from kart_tpu.ops import resolve as jres
from kart_tpu_torch.ops import fm_search as tfm
from kart_tpu_torch.ops import pack as tpack
from kart_tpu_torch.ops import resolve as tres

from conftest import make_genome
from test_fm_kernels import simulate_reads
from test_torch_fm_search import _reads, _sensitive_reads

torch.set_num_threads(1)
MIN_SEED = 13


@pytest.fixture(scope="module")
def index(workdir):
    """A 24 kb two-chromosome genome with N runs, in both packages."""
    fa = workdir / "torch_sampled.fa"
    fa.write_text(make_genome(np.random.default_rng(17), [14000, 10000], n_runs=2))
    prefix = workdir / "torch_sampled_idx"
    build_index(str(fa), str(prefix), verbose=False)
    return load_index(str(prefix))


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def arrays64(gidx) -> dict:
    """The int64 twin of the genome's device FM arrays (as
    tests/test_fm_i64.py::_fm64 forces them), with the full SA."""
    d = gidx.device_arrays
    wide = {k: np.asarray(d[k]).astype(np.int64) for k in ("occ_cp", "sa_samples", "L2")}
    return dict(wide, bwt_words=np.asarray(d["bwt_words"]), primary=np.int64(d["primary"]),
                seq_len=np.int64(d["seq_len"]), sa_full=gidx.sa_full.astype(np.int64))


def both_fms(gidx, dtype):
    """(kart_tpu FMIndexArrays, FMIndexTensors on the CPU) of one index dtype;
    int64 needs x64 on."""
    if dtype == "int32":
        return jfm.FMIndexArrays.from_genome_index(gidx), tfm.FMIndexTensors.from_genome_index(
            gidx, "cpu")
    a = arrays64(gidx)
    j = jfm.FMIndexArrays(**{k: jnp.asarray(v.reshape(-1) if v.ndim else v) for k, v in a.items()})
    assert j.occ_cp.dtype == jnp.int64
    return j, tfm.FMIndexTensors.from_numpy(a, "cpu")


def walk_rows(gidx, n=2000):
    """Random SA rows and the rows at the edges: 1, 31, 32, primary and its
    neighbours, seq_len."""
    rng = np.random.default_rng(3)
    rows = rng.integers(1, gidx.seq_len + 1, n).astype(np.int64)
    p = int(gidx.primary)
    rows[:7] = [1, 31, 32, p - 1, p, p + 1, gidx.seq_len]
    return rows


@pytest.mark.parametrize("max_steps", [4096, 8])
@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_sa_walk_plain_matches_jax(index, request, dtype, max_steps):
    """(pos, done) of every row equal kart_tpu's sa_walk, also for the walks
    that max_steps 8 cuts (pos still steps + sa_samples[row >> 5]); where
    done, pos is the full SA's."""
    if dtype == "int64":
        request.getfixturevalue("x64")
    gidx = index
    j, t = both_fms(gidx, dtype)
    rows = walk_rows(gidx).astype(np.int32 if dtype == "int32" else np.int64)
    want_pos, want_done = (np.asarray(x) for x in jfm.sa_walk(j, jnp.asarray(rows),
                                                              max_steps=max_steps))
    pos, done = tfm.sa_walk(t, torch.from_numpy(rows), max_steps=max_steps)
    assert pos.dtype == (torch.int32 if dtype == "int32" else torch.int64)
    assert want_pos.dtype == pos.numpy().dtype
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    np.testing.assert_array_equal(done.numpy(), want_done)
    d = done.numpy()
    np.testing.assert_array_equal(pos.numpy()[d], gidx.sa_full[rows[d]])
    if max_steps == 8:
        assert 0.3 * len(rows) < (~d).sum() < 0.9 * len(rows)
    else:
        assert d.all()


def test_sa_walk_rows_wider_than_the_index(index):
    """int64 rows on an int32 index walk to the same rows, in int64."""
    gidx = index
    t = tfm.FMIndexTensors.from_genome_index(gidx, "cpu")
    rows = walk_rows(gidx, 300)
    pos32, done32 = tfm.sa_walk(t, torch.from_numpy(rows.astype(np.int32)), max_steps=8)
    pos64, done64 = tfm.sa_walk(t, torch.from_numpy(rows), max_steps=8)
    assert pos64.dtype == torch.int64
    assert torch.equal(pos64, pos32.long()) and torch.equal(done64, done32)
    with pytest.raises(ValueError, match="unsupported device"):
        tfm.sa_walk(t, torch.from_numpy(rows).to("meta"))


def test_from_genome_index_without_full_sa_leaves_it_unbuilt(workdir):
    """with_full_sa=False (the sampled mode) never reads gidx.sa_full, so the
    cached property is never computed, even without the .saf sidecar;
    auto carries it below 2**31 text bases, in the index dtype."""
    import os

    from kart_tpu_torch.index import load_index as port_load

    fa = workdir / "torch_sampled_nosaf.fa"
    fa.write_text(make_genome(np.random.default_rng(23), [9000], n_runs=1))
    prefix = str(workdir / "torch_sampled_nosaf_idx")
    build_index(str(fa), prefix, verbose=False)
    os.remove(prefix + ".saf")
    gidx = port_load(prefix)
    fm = tfm.FMIndexTensors.from_genome_index(gidx, "cpu", with_full_sa=False)
    assert fm.sa_full is None and "sa_full" not in gidx.__dict__
    fm = tfm.FMIndexTensors.from_genome_index(gidx, "cpu")
    assert fm.sa_full is not None and fm.sa_full.dtype == torch.int32
    assert "sa_full" in gidx.__dict__


@pytest.mark.parametrize("case", ["fixed", "variable", "dropped"])
def test_seed_scan_i64_matches_jax(index, x64, case):
    """The FastMode stepper on an int64 index: kart_tpu's int64 packed array,
    and the int32 index's result widened."""
    gidx = index
    j64, t64 = both_fms(gidx, "int64")
    t32 = tfm.FMIndexTensors.from_genome_index(gidx, "cpu")
    reads, rlens, l_max, ms = _reads(gidx, case)
    want = np.asarray(jfm.seed_scan(j64, reads, rlens, np.int32(MIN_SEED), max_seeds=ms,
                                    l_max=l_max))
    r, rl = torch.from_numpy(reads), torch.from_numpy(rlens)
    got = tfm.seed_scan(t64, r, rl, MIN_SEED, max_seeds=ms, l_max=l_max)
    assert want.dtype == np.int64 and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    narrow = tfm.seed_scan(t32, r, rl, MIN_SEED, max_seeds=ms, l_max=l_max)
    assert torch.equal(got, narrow.long()) and int(narrow[:, 0].sum()) > 0


@pytest.mark.parametrize("case", ["long", "ragged", "trip_cut", "dropped"])
def test_sensitive_scan_i64_matches_jax(index, x64, case):
    """The SensitiveMode stepper on an int64 index, as FastMode's."""
    gidx = index
    j64, t64 = both_fms(gidx, "int64")
    t32 = tfm.FMIndexTensors.from_genome_index(gidx, "cpu")
    reads, rlens, l_max, ms = _sensitive_reads(gidx, case)
    want = np.asarray(jfm.sensitive_scan(j64, reads, rlens, np.int32(MIN_SEED), max_seeds=ms,
                                         l_max=l_max))
    r, rl = torch.from_numpy(reads), torch.from_numpy(rlens)
    got = tfm.sensitive_scan(t64, r, rl, MIN_SEED, max_seeds=ms, l_max=l_max)
    assert want.dtype == np.int64 and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    narrow = tfm.sensitive_scan(t32, r, rl, MIN_SEED, max_seeds=ms, l_max=l_max)
    assert torch.equal(got, narrow.long()) and int(narrow[:, 0].sum()) > 0


def entry_args(reads_i8, rlens):
    """The host packer's arrays of a batch for both packages' entry points."""
    words, amb_r, amb_p = jpack.pack_reads_2bit(reads_i8)
    jargs = (jnp.asarray(words), jnp.asarray(amb_r), jnp.asarray(amb_p), jnp.asarray(rlens),
             np.int32(MIN_SEED))
    targs = (torch.from_numpy(words.view(np.int32)), torch.from_numpy(amb_r),
             torch.from_numpy(amb_p), torch.from_numpy(rlens), MIN_SEED)
    return jargs, targs


# name: (entry point, index dtype, pack16)
RESOLVED_CASES = {
    "seed_int32": ("seed", "int32", False),
    "seed_int32_pack16": ("seed", "int32", True),
    "seed_int64": ("seed", "int64", False),
    "sensitive_int32": ("sensitive", "int32", False),
    "sensitive_int64": ("sensitive", "int64", False),
}


@pytest.mark.parametrize("name", list(RESOLVED_CASES))
def test_resolved_packed_sampled_matches_jax(index, request, name):
    """seed_scan_resolved_packed and sensitive_scan_resolved_packed with
    sa_mode "sampled" (no full SA given) equal kart_tpu's, and carry the
    same reads and positions as the full-SA stream; an int64 index gives
    the (cnts, meta, gpos) tuple."""
    kind, dtype, pack16 = RESOLVED_CASES[name]
    if dtype == "int64":
        request.getfixturevalue("x64")
    gidx = index
    j, t = both_fms(gidx, dtype)
    j_sampled = jfm.FMIndexArrays(**{**{f: getattr(j, f) for f in (
        "occ_cp", "bwt_words", "sa_samples", "L2", "primary", "seq_len")}, "sa_full": None})
    if kind == "seed":
        l_max, B = 128, 40
        reads = np.full((B, l_max), 4, np.int8)
        reads[:, :120] = simulate_reads(gidx, B, 120)
        rlens = np.full(B, 120, np.int32)
        rlens[-3:] = [0, 20, 5]
        ms, H = l_max // (MIN_SEED + 1) + 1, 3 * B
        jfn, tfn = jpack.seed_scan_resolved_packed, tpack.seed_scan_resolved_packed
    else:
        reads32, rlens, _, _ = _sensitive_reads(gidx, "long")
        l_max = 512
        reads = np.full((len(rlens), l_max), 4, np.int8)
        reads[:, : reads32.shape[1]] = reads32
        ms, H = l_max // MIN_SEED + 2, len(rlens) * 64
        jfn, tfn = jpack.sensitive_scan_resolved_packed, tpack.sensitive_scan_resolved_packed
    B = len(rlens)
    jargs, targs = entry_args(reads, rlens)
    kw = dict(max_seeds=ms, l_max=l_max, occ_budget=H, pack16=pack16)
    want = jpack.unpack_stream(jfn(j_sampled, *jargs, sa_mode="sampled", **kw), B, H, pack16)
    got = tfn(t, None, *targs, sa_mode="sampled", **kw)
    assert isinstance(got, tuple) == (dtype == "int64")
    got = tpack.unpack_stream(got.numpy() if not isinstance(got, tuple) else got, B, H, pack16)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(g, w)
    assert got[2].dtype == (np.int32 if dtype == "int32" else np.int64)
    full = tfn(t, t.sa_full, *targs, sa_mode="full", **kw)
    full = tpack.unpack_stream(full.numpy() if not isinstance(full, tuple) else full, B, H, pack16)
    for f, g in zip(full, got):
        np.testing.assert_array_equal(g, f)
    assert (got[0] > 0).sum() >= B // 2
    with pytest.raises(ValueError, match="needs the full SA"):
        tfn(t, None, *targs, sa_mode="full", **kw)


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_expand_resolve_with_a_cut_walk_matches_jax(index, request, dtype):
    """expand_resolve with the lookup sa_walk(..., max_steps=8) on both
    sides: reads with a walk cut short are flagged (cnts -tot-1) with their
    meta and positions left in the stream; equal to kart_tpu's."""
    if dtype == "int64":
        request.getfixturevalue("x64")
    gidx = index
    j, t = both_fms(gidx, dtype)
    rng = np.random.default_rng(8)
    B, S, H = 60, 5, 200
    idt = np.int32 if dtype == "int32" else np.int64
    n_seeds = rng.integers(0, S + 1, B).astype(np.int32)
    rpos = rng.integers(0, 150, (B, S)).astype(np.int32)
    slen = rng.integers(13, 151, (B, S)).astype(np.int32)
    freq = rng.integers(0, 4, (B, S)).astype(idt)
    k0 = rng.integers(1, gidx.seq_len - 4, (B, S)).astype(idt)
    ok_in = rng.random(B) < 0.9
    blocks = (n_seeds, rpos, slen, k0, freq, ok_in)
    want = jres.expand_resolve(lambda rows: jfm.sa_walk(j, rows, max_steps=8),
                               *map(jnp.asarray, blocks), occ_budget=H)
    got = tres.expand_resolve_plain(tres.sampled_lookup(t, 8), *map(torch.from_numpy, blocks),
                                    occ_budget=H)
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert w.dtype == g.numpy().dtype
        np.testing.assert_array_equal(g.numpy(), w)
    cnts = got[0].numpy()
    ok, tot, offs = tres.decode_resolved_counts(cnts)
    fits = offs[1:] <= H
    cut = fits & ok_in & ~ok & (tot > 0)
    assert cut.sum() >= 5, "max_steps 8 must flag reads that fit the budget"
    r = int(np.nonzero(cut)[0][0])
    assert (got[1].numpy()[offs[r] : offs[r + 1]] >= 0).all()  # their meta stays
