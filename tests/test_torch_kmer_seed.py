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


@pytest.fixture(scope="module")
def kmer_genome(workdir):
    """~36 kb genome: random sequence around 40 copies (1% diverged) of one
    300 bp element, and a 40 bp poly-A run."""
    d = workdir / "torch_kmer"
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
    from the host packer's 2-bit words."""
    tb, results = jax_scans
    c = results[name]
    l_max = c["l_max"]
    words, amb_r, amb_p = tpack.pack_reads_2bit(c["reads"].astype(np.int8))
    tt = tks.KmerTablesTensors.from_tables(tb, "cpu")
    got = tpack.kmer_seed_scan_resolved_packed(
        tt, torch.from_numpy(words.view(np.int32)), torch.from_numpy(amb_r),
        torch.from_numpy(amb_p), torch.from_numpy(c["rlens"]), MIN_SEED,
        max_seeds=l_max // 14 + 1, l_max=l_max, hit_cap=c["hit_cap"], rounds=l_max // 10 + 4,
        occ_budget=2 * len(c["rlens"]), pack16=True, slab_rows=c["slab"],
        hit_budget=c["hit_budget"],
    )
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), c["want_stream"])


def test_sensitive_mode_not_ported(kmer_genome):
    tt = tks.KmerTablesTensors.from_tables(tks.build_tables(kmer_genome), "cpu")
    reads = torch.full((2, 64), 4, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="item 7"):
        tks.kmer_seed_scan(tt, reads, torch.zeros(2, dtype=torch.int32), MIN_SEED, max_seeds=5,
                           l_max=64, hit_cap=16, rounds=10, sensitive=True)
