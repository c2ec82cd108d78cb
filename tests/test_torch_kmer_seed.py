"""The port's 13-mer funnel against kart_tpu's (`kart_tpu/ops/kmer_seed.py`):
the tables array for array and through each other's `.kmt` sidecar, and
the FastMode scan byte for byte at l_max 64, 160 and 256, over batches cut
into several slabs plus padding, with ambiguous bases, short reads, deep
repeats and poly-A runs (bogus short-suffix rows), and with a hit budget and
hit_cap small enough that lanes are flagged; also the shapes that the CUDA
kernel's clusters of 8 blocks a slab treat apart (a batch smaller than one
slab, a slab that 8 does not divide, with and without flagged lanes), so
that the plain version is the right oracle for the card's byte-equality.

kart_tpu reads its slab size and hit budget (`_SLAB_ROWS`, `_HIT_BUDGET`)
from the environment when the module is imported, so its scans run in a
subprocess per setting: no jit trace made under another setting is reused.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from kart_tpu.index import build_index, load_index
from kart_tpu.ops import kmer_seed as jks
from kart_tpu.ops import pack as jpack
from kart_tpu_torch.ops import kmer_seed as tks
from kart_tpu_torch.ops import pack as tpack

REPO = Path(__file__).resolve().parent.parent
torch.set_num_threads(1)
_ACGT = np.frombuffer(b"ACGT", np.uint8)
MIN_SEED = 13

# name: (l_max, B, hit_cap or None for kart_tpu's); per setting of
# (slab rows, hit budget) of both versions
SETTINGS = {
    (128, 2): {"l64": (64, 300, None), "l160": (160, 400, None), "l256": (256, 260, None),
               "sub_slab": (160, 100, None)},
    (96, 1): {"flagged": (160, 300, 16), "sub_slab_flagged": (160, 76, 16)},
    (100, 2): {"slab_not_divisible": (160, 250, None)},
    (100, 1): {"slab_not_divisible_flagged": (64, 350, 16)},
}


def build_repeat_genome(d):
    """~36 kb genome in directory d: random sequence around 40 copies (1%
    diverged) of one 300 bp element, and a 40 bp poly-A run; indexed as
    d/idx."""
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
    return load_index(str(d / "idx"))


@pytest.fixture(scope="module")
def kmer_genome(workdir):
    return build_repeat_genome(workdir / "torch_kmer")


def make_reads(gidx, B, l_max, seed):
    """(B, l_max) int32 codes padded 4 and rlens: a third full length, the
    rest 20..l_max; 2% substitutions; Ns in a fifth; a poly-A prefix in some."""
    rng = np.random.default_rng(seed)
    codes = gidx.ref_codes
    reads = np.full((B, l_max), 4, np.int32)
    rlens = np.zeros(B, np.int32)
    for i in range(B):
        rl = l_max if i % 3 == 0 else int(rng.integers(20, l_max + 1))
        p = int(rng.integers(0, gidx.two_genome_size - rl))
        r = codes[p : p + rl].astype(np.int32)
        m = rng.random(rl) < 0.02
        r[m] = (r[m] + rng.integers(1, 4, int(m.sum()))) % 4
        if i % 5 == 0:
            r[rng.integers(0, rl, 2)] = 4
        if i % 17 == 0:
            r[:15] = 0
        reads[i, :rl] = r
        rlens[i] = rl
    return reads, rlens


def test_build_tables_match_and_share_sidecar(kmer_genome):
    """Fresh builds equal array for array; kart_tpu reads the port's .kmt
    and the port reads kart_tpu's."""
    kmt = kmer_genome.raw.prefix + ".kmt"
    if os.path.exists(kmt):
        os.remove(kmt)
    port = tks.build_tables(kmer_genome)  # fresh build, writes the sidecar
    assert os.path.exists(kmt)
    jax_read = jks.build_tables(kmer_genome)
    os.remove(kmt)
    jax_fresh = jks.build_tables(kmer_genome)  # fresh build, writes the sidecar
    port_read = tks.build_tables(kmer_genome)
    assert port.all_short_present and 40 <= port.max_mult <= 4096
    for a, b in ((port, jax_fresh), (jax_read, jax_fresh), (port_read, port)):
        for name in ("table_lo_np", "text_np", "sa_full_np", "sub_tbl_np"):
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
        assert len(a.bitmaps_np) == len(b.bitmaps_np)
        for x, y in zip(a.bitmaps_np, b.bitmaps_np):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        assert (a.seq_len, a.max_mult, a.all_short_present) == (
            b.seq_len, b.max_mult, b.all_short_present)
    np.testing.assert_array_equal(port.text_words_np(), np.asarray(jax_fresh.text_words))


_JAX_SCANS = """
import sys
import numpy as np
from kart_tpu.index import load_index
from kart_tpu.ops.kmer_seed import build_tables, kmer_seed_scan
from kart_tpu.ops.pack import kmer_seed_scan_resolved_packed, pack_reads_2bit
prefix, inp, outp = sys.argv[1:4]
tb = build_tables(load_index(prefix))
z = np.load(inp)
out = {}
for name in z["names"]:
    reads, rlens = z[name + "_reads"], z[name + "_rlens"]
    l_max, hit_cap = int(z[name + "_lmax"]), int(z[name + "_hitcap"])
    kw = dict(max_seeds=l_max // 14 + 1, l_max=l_max, hit_cap=hit_cap,
              rounds=l_max // 10 + 4, seq_len=tb.seq_len)
    out[name] = np.asarray(kmer_seed_scan(tb.table_lo, tb.text_words, tb.sa_full, tb.sub_tbl,
                                          reads, rlens, np.int32(13), **kw))
    words, amb_r, amb_p = pack_reads_2bit(reads.astype(np.int8))
    out[name + "_stream"] = np.asarray(kmer_seed_scan_resolved_packed(
        tb.table_lo, tb.text_words, tb.sa_full, tb.sub_tbl, words, amb_r, amb_p, rlens,
        np.int32(13), occ_budget=2 * len(rlens), pack16=True, **kw))
np.savez(outp, **out)
"""


@pytest.fixture(scope="module")
def jax_scans(kmer_genome, tmp_path_factory):
    """kart_tpu's scans of every case, one subprocess per setting."""
    tmp = tmp_path_factory.mktemp("kmer_scans")
    tb = tks.build_tables(kmer_genome)
    results = {}
    for (slab, hb), cases in SETTINGS.items():
        inp, outp = tmp / f"in_{slab}_{hb}.npz", tmp / f"out_{slab}_{hb}.npz"
        arrs = {"names": np.array(list(cases))}
        for name, (l_max, B, hit_cap) in cases.items():
            reads, rlens = make_reads(kmer_genome, B, l_max, seed=l_max + B)
            arrs.update({name + "_reads": reads, name + "_rlens": rlens,
                         name + "_lmax": l_max,
                         name + "_hitcap": hit_cap or tks.hit_cap_for(tb.max_mult)})
        np.savez(inp, **arrs)
        env = dict(os.environ, KART_SLAB_ROWS=str(slab), KART_HIT_BUDGET=str(hb),
                   JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
        proc = subprocess.run(
            [sys.executable, "-c", _JAX_SCANS, kmer_genome.raw.prefix, str(inp), str(outp)],
            capture_output=True, text=True, timeout=600, env=env,
        )
        assert proc.returncode == 0, proc.stderr[-3000:]
        got = np.load(outp)
        z = np.load(inp)
        for name in cases:
            results[name] = dict(
                slab=slab, hit_budget=hb, reads=z[name + "_reads"], rlens=z[name + "_rlens"],
                l_max=int(z[name + "_lmax"]), hit_cap=int(z[name + "_hitcap"]),
                want=got[name], want_stream=got[name + "_stream"],
            )
    return tb, results


CASES = [name for cases in SETTINGS.values() for name in cases]


@pytest.mark.parametrize("name", CASES)
def test_kmer_seed_scan_plain_matches(jax_scans, name):
    tb, results = jax_scans
    c = results[name]
    l_max, B = c["l_max"], c["reads"].shape[0]
    if name.startswith("sub_slab"):
        assert B < c["slab"], "one slab of B rows"
    else:
        assert B > c["slab"] and B % c["slab"], "several slabs plus padding"
    if name.startswith("slab_not_divisible"):
        assert c["slab"] % 8, "the last block of a cluster of 8 has fewer lanes"
    tt = tks.KmerTablesTensors.from_tables(tb, "cpu")
    got = tks.kmer_seed_scan_plain(
        tt, torch.from_numpy(c["reads"]), torch.from_numpy(c["rlens"]), MIN_SEED,
        max_seeds=l_max // 14 + 1, l_max=l_max, hit_cap=c["hit_cap"], rounds=l_max // 10 + 4,
        slab_rows=c["slab"], hit_budget=c["hit_budget"],
    )
    assert got.dtype == torch.int32 and c["want"].dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), c["want"])
    out = tks.unpack_seed_result(c["want"], l_max // 14 + 1)
    assert out["n_seeds"].sum() > B // 2 and (c["reads"] == 4).any()
    if name.endswith("flagged"):
        assert (~out["ok"]).sum() > 10, "the small budget and hit_cap must flag lanes"


@pytest.mark.parametrize("name", CASES)
def test_kmer_seed_scan_resolved_packed_matches(jax_scans, name):
    """The fused CPU path: plain unpack, funnel, expand/resolve and pack16,
    from the host packer's 2-bit words, with the port's list of runs and
    with kart_tpu's list of positions."""
    tb, results = jax_scans
    c = results[name]
    l_max = c["l_max"]
    reads = c["reads"].astype(np.int8)
    words, amb_r, amb_p = tpack.pack_reads_2bit(reads)
    _, point_r, point_p = jpack.pack_reads_2bit(reads)
    assert (amb_r < len(reads)).sum() < (point_r < len(reads)).sum()
    tt = tks.KmerTablesTensors.from_tables(tb, "cpu")
    for r, p in ((amb_r, amb_p), (point_r, point_p)):
        got = tpack.kmer_seed_scan_resolved_packed(
            tt, torch.from_numpy(words.view(np.int32)), torch.from_numpy(r), torch.from_numpy(p),
            torch.from_numpy(c["rlens"]), MIN_SEED, max_seeds=l_max // 14 + 1, l_max=l_max,
            hit_cap=c["hit_cap"], rounds=l_max // 10 + 4, occ_budget=2 * len(c["rlens"]),
            pack16=True, slab_rows=c["slab"], hit_budget=c["hit_budget"],
        )
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), c["want_stream"])


# ---------------------------------------------------------------------------
# SensitiveMode (PacBio)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sens_genome(workdir):
    """The 20 kb random genome of tests/test_fm_kernels.py (tiny_index)."""
    from conftest import make_genome

    d = workdir / "torch_kmer_sens"
    d.mkdir(exist_ok=True)
    fa = d / "g.fa"
    fa.write_text(make_genome(np.random.default_rng(5), [20000], n_runs=0))
    build_index(str(fa), str(d / "idx"), verbose=False)
    return load_index(str(d / "idx"))


def sensitive_batch(gidx, n=12, rlen=700, l_max=None, seed=11):
    """The batch of test_kmer_sensitive_scan_matches_fm_sensitive: n reads
    of rlen bases at 15% substitutions, four Ns in every third; padded to
    l_max with shorter reads and a pad lane when l_max is given."""
    rng = np.random.default_rng(seed)
    codes = gidx.ref_codes
    l_max = l_max or rlen
    reads = np.full((n, l_max), 4, np.int32)
    rlens = np.full(n, rlen, np.int32)
    for i in range(n):
        p = rng.integers(0, gidx.two_genome_size - rlen)
        r = codes[p : p + rlen].astype(np.int32)
        nmut = rng.binomial(rlen, 0.15)
        idx = rng.integers(0, rlen, size=nmut)
        r[idx] = (r[idx] + rng.integers(1, 4, size=nmut)) % 4
        if i % 3 == 0:
            r[rng.integers(0, rlen, 4)] = 4
        reads[i, :rlen] = r
    if l_max > rlen:  # ragged: short reads, a read below MinSeed, a pad lane
        for i, rl in ((1, 221), (4, 12), (5, 0), (7, 40)):
            reads[i, rl:] = 4
            rlens[i] = rl
    return reads, rlens


def jax_sensitive_funnel(tb_jax, reads, rlens, *, ms, l_max, hit_cap, rounds):
    return np.asarray(jks.kmer_seed_scan(
        tb_jax.table_lo, tb_jax.text_words, tb_jax.sa_full, tb_jax.sub_tbl, reads, rlens,
        np.int32(MIN_SEED), max_seeds=ms, l_max=l_max, hit_cap=hit_cap, rounds=rounds,
        seq_len=tb_jax.seq_len, sensitive=True))


@pytest.mark.parametrize("case", ["clean_12x700", "ragged_l1024", "few_rounds"])
def test_sensitive_funnel_plain_matches(sens_genome, case):
    """The plain SensitiveMode funnel against kart_tpu's
    kmer_seed_scan(sensitive=True), and against the port's own FM
    SensitiveMode scan where the lane is ok."""
    from kart_tpu_torch.ops import fm_search as tfm

    l_max = 1024 if case == "ragged_l1024" else 700
    reads, rlens = sensitive_batch(sens_genome, l_max=l_max)
    ms = l_max // MIN_SEED + 2
    rounds = 20 if case == "few_rounds" else l_max // MIN_SEED + 8
    tb = tks.build_tables(sens_genome, cache=False)
    hit_cap = tks.hit_cap_for(tb.max_mult)
    want = jax_sensitive_funnel(jks.build_tables(sens_genome, cache=False), reads, rlens, ms=ms,
                                l_max=l_max, hit_cap=hit_cap, rounds=rounds)
    tt = tks.KmerTablesTensors.from_tables(tb, "cpu")
    got = tks.kmer_seed_scan(tt, torch.from_numpy(reads), torch.from_numpy(rlens), MIN_SEED,
                             max_seeds=ms, l_max=l_max, hit_cap=hit_cap, rounds=rounds,
                             sensitive=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    out = tks.unpack_seed_result(want, ms)
    if case == "few_rounds":  # lanes not finished after `rounds` are flagged
        assert (~out["ok"]).sum() >= 8
    else:
        assert out["ok"].all() and out["n_seeds"].sum() > 40
    fm = tfm.FMIndexTensors.from_genome_index(sens_genome, "cpu")
    exact = tfm.sensitive_scan_plain(fm, torch.from_numpy(reads), torch.from_numpy(rlens),
                                     MIN_SEED, max_seeds=ms, l_max=l_max).numpy()
    ok = out["ok"]
    np.testing.assert_array_equal(np.delete(want, 1, axis=1)[ok], exact[ok])


def repeat_batch(gidx, B, l_max, seed=3):
    """Reads that all start inside the 40-copy element of kmer_genome, so
    that the first rounds ask for some 40 hits a lane."""
    rng = np.random.default_rng(seed)
    codes = gidx.ref_codes
    elem_at = 0
    # the first copy follows the first random stretch: find a 13-mer with 40 hits
    tb = tks.build_tables(gidx)
    mult = np.diff(tb.table_lo_np)
    km = 0
    for j in range(len(codes) - 13):
        km = int("".join(str(c) for c in codes[j : j + 13]), 4)
        if mult[km] >= 30:
            elem_at = j
            break
    reads = np.full((B, l_max), 4, np.int32)
    rlens = np.zeros(B, np.int32)
    for i in range(B):
        rl = int(rng.integers(300, l_max + 1))
        r = codes[elem_at : elem_at + rl].astype(np.int32)
        m = rng.random(rl) < 0.1
        m[:40] = False
        r[m] = (r[m] + rng.integers(1, 4, int(m.sum()))) % 4
        reads[i, :rl] = r
        rlens[i] = rl
    return reads, rlens


def test_sensitive_funnel_budget_flags_lanes(kmer_genome):
    """A repeat family above 4 * B hits in one round: the lanes past the
    budget are flagged, the same ones as in kart_tpu."""
    B, l_max = 10, 512
    reads, rlens = repeat_batch(kmer_genome, B, l_max)
    ms = l_max // MIN_SEED + 2
    tb = tks.build_tables(kmer_genome)
    hit_cap = tks.hit_cap_for(tb.max_mult)
    kw = dict(ms=ms, l_max=l_max, hit_cap=hit_cap, rounds=l_max // MIN_SEED + 8)
    want = jax_sensitive_funnel(jks.build_tables(kmer_genome), reads, rlens, **kw)
    tt = tks.KmerTablesTensors.from_tables(tb, "cpu")
    got = tks.kmer_seed_scan_plain(tt, torch.from_numpy(reads), torch.from_numpy(rlens), MIN_SEED,
                                   max_seeds=ms, l_max=l_max, hit_cap=hit_cap,
                                   rounds=kw["rounds"], sensitive=True)
    np.testing.assert_array_equal(got.numpy(), want)
    ok = want[:, 1] != 0
    assert 0 < ok.sum() < B, "the budget must flag some lanes and spare the first"


_ENV_SCANS = """
import sys
import numpy as np
import torch
from kart_tpu.index import load_index
from kart_tpu.ops import kmer_seed as jks
from kart_tpu.ops import pack as jpack
from kart_tpu_torch.ops import kmer_seed as tks
assert (jks._SLAB_ROWS, jks._HIT_BUDGET) == (tks.SLAB_ROWS, tks.HIT_BUDGET) == (96, 1)
z = np.load(sys.argv[2])
reads, rlens = z["reads"], z["rlens"]
gidx = load_index(sys.argv[1])
tj, tb = jks.build_tables(gidx), tks.build_tables(gidx)
kw = dict(max_seeds=160 // 14 + 1, l_max=160, hit_cap=16, rounds=160 // 10 + 4)
want = np.asarray(jks.kmer_seed_scan(tj.table_lo, tj.text_words, tj.sa_full, tj.sub_tbl, reads,
                                     rlens, np.int32(13), seq_len=tj.seq_len, **kw))
tt = tks.KmerTablesTensors.from_tables(tb, "cpu")
# neither the slab nor the budget is passed: the defaults come from the environment
got = tks.kmer_seed_scan(tt, torch.from_numpy(reads), torch.from_numpy(rlens), 13, **kw).numpy()
assert np.array_equal(got, want)
print("FLAGGED", int((want[:, 1] == 0).sum()))
"""


def test_slab_rows_and_hit_budget_from_environment(kmer_genome, tmp_path):
    """KART_SLAB_ROWS and KART_HIT_BUDGET are read where kart_tpu reads them:
    with both set the port's funnel flags the lanes kart_tpu's flags."""
    reads, rlens = make_reads(kmer_genome, 300, 160, seed=460)
    np.savez(tmp_path / "in.npz", reads=reads, rlens=rlens)
    env = dict(os.environ, KART_SLAB_ROWS="96", KART_HIT_BUDGET="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=f"{REPO}:{REPO / 'tests'}")
    proc = subprocess.run(
        [sys.executable, "-c", _ENV_SCANS, kmer_genome.raw.prefix, str(tmp_path / "in.npz")],
        capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split("FLAGGED")[1]) > 10


@pytest.mark.parametrize("sensitive,l_max", [(False, 513), (True, 32769)])
def test_l_max_bound_follows_the_mode(kmer_genome, sensitive, l_max):
    tt = tks.KmerTablesTensors.from_tables(tks.build_tables(kmer_genome), "cpu")
    reads = torch.full((2, l_max), 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="l_max <="):
        tks.kmer_seed_scan(tt, reads, torch.zeros(2, dtype=torch.int32), MIN_SEED, max_seeds=5,
                           l_max=l_max, hit_cap=16, rounds=10, sensitive=sensitive)
