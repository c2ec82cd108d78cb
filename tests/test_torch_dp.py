"""The port's multi-device mapping steps (kart_tpu_torch/parallel/dp.py), its
entry points (kart_tpu_torch/graft_entry.py) and its scaling tools against
kart_tpu's.

kart_tpu's steps run as shard_map over meshes of the forced host devices
(tests/conftest.py), the port's over meshes of [cpu] * n.  Every comparison
is exact: the outputs are integers and masks, and each array must be equal
element for element and in dtype.

- F, the PosDiff sort: `sorted_occurrences_plain` against kart_tpu's
  `_sorted_occurrences` on tools/simdata's synthetic streams (a flagged
  read whose entries stay in the stream, meta's sign bit, reads past s_occ,
  ties, invalid slots, entries past H, 5,000 mixed reads), gpos int32 and int64 (jax_enable_x64 on, then off
  after); and `csrc/sorted_occ.cu` on the same streams and on batches
  around its tiles of 128 and 64 reads (1 to 32,000, s_occ 16 and 32,
  flagged reads and the end of H on a tile's edge) through the host shim
  (tests/host_shim), against the plain version.
- make_mapping_step at data 1, data 8 and data x idx 2 x 4.
- make_full_mapping_step, every output array (the flat stream included), at
  data 1 and 4 with the full SA, data 2 sampled, 2 x 2 full and sampled, on
  a batch of pairs and on one whose repeat reads overrun the blocks'
  budgets (flagged suffixes).
- The refusals; graft_entry's tiny index, entry() and dry run against the
  root __graft_entry__.py; bench_scaling and scaling_curve with --cpu, and
  refusing without a card.
"""

import contextlib
import ctypes
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as root_entry
import kart_tpu_torch
from kart_tpu.index import build_index, load_index
from kart_tpu.parallel import dp as jdp
from kart_tpu_torch import graft_entry
from kart_tpu_torch.index import load_index as torch_load_index
from kart_tpu_torch.index.loader import GenomeIndex as TorchGenomeIndex
from kart_tpu_torch.parallel import dp as tdp
from kart_tpu_torch.tools import bench_scaling, scaling_curve, simdata
from host_shim import translate

torch.set_num_threads(1)
CPU = torch.device("cpu")
MIN_SEED, RLEN = 13, 48
MAX_SEEDS = RLEN // (MIN_SEED + 1) + 1
REPEAT, N_COPIES = 700, 8
MATE_GAP = 200  # read 2 starts this far after read 1, on the same strand


@contextlib.contextmanager
def x64(on: bool):
    """jax_enable_x64 as asked inside the block, off after."""
    jax.config.update("jax_enable_x64", on)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


# ---------------------------------------------------------------------------
# F: the PosDiff sort on synthetic streams
# ---------------------------------------------------------------------------


def jax_sorted(cnts, meta, gpos, B, s_occ):
    with x64(gpos.dtype == np.int64):
        out = jdp._sorted_occurrences(jnp.asarray(cnts), jnp.asarray(meta), jnp.asarray(gpos), B,
                                      s_occ)
        return [np.asarray(x) for x in out]


def assert_same(got, want, what=""):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.dtype == w.dtype, f"{what} output {i}: dtype {g.dtype} != {w.dtype}"
        np.testing.assert_array_equal(g, w, err_msg=f"{what} output {i}")


@pytest.mark.parametrize("dtype", ["int32", "int64"])
@pytest.mark.parametrize("name", simdata.OCC_STREAMS)
def test_sorted_occurrences_plain_matches_jax(name, dtype):
    cnts, meta, gpos, B, s_occ = simdata.occurrence_stream(name, dtype)
    got = tdp.sorted_occurrences_plain(torch.from_numpy(cnts), torch.from_numpy(meta),
                                       torch.from_numpy(gpos), B, s_occ)
    want = jax_sorted(cnts, meta, gpos, B, s_occ)
    assert_same(got, want, name)
    assert_same(tdp._sorted_occurrences(torch.from_numpy(cnts), torch.from_numpy(meta),
                                        torch.from_numpy(gpos), B, s_occ), want, name)
    if name == "flagged_keeps_entries":  # read 2 sorts the flagged read's entries
        assert list(got[0].numpy()) == [3, 0, 2, 5, 0, 4]


@pytest.fixture(scope="module")
def sorted_occ_lib(tmp_path_factory):
    """csrc/sorted_occ.cu compiled as host C++ (tests/host_shim)."""
    so = tmp_path_factory.mktemp("host_shim_sorted") / "libsortedocc.so"
    csrc = os.path.join(os.path.dirname(os.path.abspath(kart_tpu_torch.__file__)), "csrc")
    translate.build(str(so), [os.path.join(csrc, "sorted_occ.cu")])
    lib = ctypes.CDLL(str(so))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for sfx in ("", "_i64"):
        fn = getattr(lib, "kart_sorted_occurrences" + sfx)
        fn.argtypes = [p, i, p, p, ll, i, p, p, p, p, p, p, p, p]
        fn.restype = i
    lib.kart_sorted_occ_state_words.argtypes = [i]
    lib.kart_sorted_occ_state_words.restype = i
    return lib


@pytest.mark.parametrize("dtype", ["int32", "int64"])
@pytest.mark.parametrize("name", simdata.OCC_STREAMS)
def test_sorted_occ_kernel_on_host_matches_plain(sorted_occ_lib, name, dtype):
    """The kernel (the tile's scan and look-back, then a lane a slot) on the
    host, its outputs starting as garbage."""
    cnts, meta, gpos, B, s_occ = simdata.occurrence_stream(name, dtype)
    want = tdp.sorted_occurrences_plain(torch.from_numpy(cnts), torch.from_numpy(meta),
                                        torch.from_numpy(gpos), B, s_occ)
    state = np.zeros(sorted_occ_lib.kart_sorted_occ_state_words(B), np.uint64)
    assert_same(host_sorted(sorted_occ_lib, cnts, meta, gpos, B, s_occ, state),
                [w.numpy() for w in want], name)


TILE = 64  # reads a block of csrc/sorted_occ.cu at s_occ 17-32; twice that at s_occ <= 16


def tile_edge_stream(B, s_occ, dtype):
    """A stream of B reads whose edges fall on the kernel's tiles: reads
    past s_occ, flagged reads at the last and first read of tiles (their
    entries stay for the reads after them), invalid slots, slen 32768, ties,
    and H cut inside the entries of a read that starts a tile (the reads
    after it take nothing).  In int64 half the positions lie past 2**32."""
    rng = np.random.default_rng(B + 7 * s_occ)
    cnts = rng.integers(-2, s_occ + 4, B).astype(np.int32)
    cnts[rng.random(B) < 0.1] = 0
    for e in range(TILE - 1, B - 1, 5 * TILE):
        cnts[e], cnts[e + 1] = -int(rng.integers(2, 9)), -1
    tot = np.maximum(cnts, 0).astype(np.int64)
    cut = (3 * B // 4) // (2 * TILE) * (2 * TILE) if B > 2 * TILE else B - 1
    if tot[cut] < 2:
        cnts[cut], tot[cut] = 5, 5
    H = int(tot[:cut].sum()) + int(tot[cut]) // 2
    rp = rng.integers(0, 3 if B % 2 else 150, H)
    slen = rng.integers(13, 60, H)
    slen[rng.random(H) < 0.2] = 32768
    slen[rng.random(H) < 0.2] = 0xFFFF
    gpos = rp + rng.integers(100, 103 if B % 2 else 5000, H)
    if dtype == "int64":
        gpos = np.where(rng.random(H) < 0.5, gpos + (1 << 33), gpos)
    meta = simdata.meta_of(rp, slen)
    return cnts, meta, gpos.astype(np.int32 if dtype == "int32" else np.int64)


def host_sorted(lib, cnts, meta, gpos, B, s_occ, state):
    """kart_sorted_occurrences through the host shim, its outputs starting
    as garbage; `state` the look-back's words, zero before the call."""
    outs = [np.full(B, -7, np.int32)] + [np.full((B, s_occ), -7, d)
                                          for d in (np.int32, np.int32, gpos.dtype, np.int32)]
    outs.append(np.full((B, s_occ), 9, np.uint8))
    sfx = "" if gpos.dtype == np.int32 else "_i64"
    assert len(state) >= lib.kart_sorted_occ_state_words(B)
    rc = getattr(lib, "kart_sorted_occurrences" + sfx)(
        cnts.ctypes.data, B, meta.ctypes.data, gpos.ctypes.data, len(meta), s_occ,
        state.ctypes.data, *(o.ctypes.data for o in outs), None)
    assert rc == 0
    outs[-1] = outs[-1].astype(bool)
    return outs


@pytest.mark.parametrize("dtype", ["int32", "int64"])
@pytest.mark.parametrize("s_occ", [16, 32])
@pytest.mark.parametrize("B", [1, TILE - 1, TILE, TILE + 1, 2 * TILE - 1, 2 * TILE, 2 * TILE + 1,
                               8300, 32000])
def test_sorted_occ_kernel_on_host_carries_across_scan_tiles(sorted_occ_lib, B, s_occ, dtype):
    """One launch over batches around the kernel's tiles (128 reads at s_occ
    16, 64 at 32), each tile's offsets from the look-back over the tiles
    before it, against the plain version; the look-back's state words are
    zero after the call (the last tile resets them), so a second call on the
    same words, on another batch, is right too."""
    cnts, meta, gpos = tile_edge_stream(B, s_occ, dtype)
    want = tdp.sorted_occurrences_plain(torch.from_numpy(cnts), torch.from_numpy(meta),
                                        torch.from_numpy(gpos), B, s_occ)
    state = np.zeros(sorted_occ_lib.kart_sorted_occ_state_words(32000), np.uint64)
    got = host_sorted(sorted_occ_lib, cnts, meta, gpos, B, s_occ, state)
    assert_same(got, [w.numpy() for w in want], f"B {B}")
    assert not state.any()
    if B == 32000:
        assert (cnts < 0).sum() > 100 and got[0][3 * B // 4 + 1:].sum() == 0
    c2, m2, g2 = tile_edge_stream(TILE + 1, s_occ, dtype)
    want2 = tdp.sorted_occurrences_plain(torch.from_numpy(c2), torch.from_numpy(m2),
                                         torch.from_numpy(g2), TILE + 1, s_occ)
    assert_same(host_sorted(sorted_occ_lib, c2, m2, g2, TILE + 1, s_occ, state),
                [w.numpy() for w in want2], "the second call")
    assert not state.any()


def test_sorted_occurrences_kernel_refuses_what_it_cannot_take():
    """The wrapper refuses a CPU tensor, and s_occ past a warp, before any
    build or launch."""
    from kart_tpu_torch import kernels

    cnts, meta, gpos, B, _ = simdata.occurrence_stream("random", "int32")
    args = (torch.from_numpy(cnts), torch.from_numpy(meta), torch.from_numpy(gpos), B)
    with pytest.raises(ValueError, match="s_occ 33"):
        kernels.sorted_occurrences(*args, 33)
    with pytest.raises(ValueError, match="expected a cuda tensor"):
        kernels.sorted_occurrences(*args, 16)


# ---------------------------------------------------------------------------
# The mapping steps against kart_tpu's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def index(workdir):
    """Two chromosomes (18 kb, 12 kb) with N runs and a 700-base repeat
    copied 8 times, loaded by both packages from one set of index files;
    the repeat copies' starts."""
    rng = np.random.default_rng(2024)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    chroms = [rng.choice(acgt, size=n) for n in (18000, 12000)]
    rep = rng.choice(acgt, size=REPEAT)
    starts = []
    for c in range(N_COPIES):
        ch = chroms[c % 2]
        p = 1000 + (c // 2) * 2500
        ch[p:p + REPEAT] = rep
        starts.append(p + (0 if c % 2 == 0 else 18000))
    chroms[0][16000:16010] = ord("N")
    fa = workdir / "torch_dp.fa"
    with open(fa, "wb") as f:
        for i, ch in enumerate(chroms):
            f.write(f">chr{i + 1}\n".encode())
            s = ch.tobytes()
            f.write(b"\n".join(s[j:j + 70] for j in range(0, len(s), 70)) + b"\n")
    prefix = str(workdir / "torch_dp_idx")
    build_index(str(fa), prefix, verbose=False)
    return load_index(prefix), torch_load_index(prefix), np.array(starts)


def pair_batch(gidx, n_pairs: int, seed: int, starts=None):
    """Rows (2i, 2i+1) are a pair: read 1 at a start, read 2 MATE_GAP bases
    on, on the same strand; one substitution in every third read, one read
    cut to 40 bases (codes 4 past its length)."""
    rng = np.random.default_rng(seed)
    codes = gidx.ref_codes
    if starts is None:
        starts = rng.integers(0, gidx.two_genome_size - RLEN - MATE_GAP, n_pairs)
    pos = np.stack([starts, starts + MATE_GAP], axis=1).reshape(-1)
    reads = codes[pos[:, None] + np.arange(RLEN)].astype(np.int32)
    sub = np.arange(len(pos)) % 3 == 1
    col = rng.integers(0, RLEN, len(pos))
    reads[sub, col[sub]] = (reads[sub, col[sub]] + 1) % 4
    rlens = np.full(len(pos), RLEN, np.int32)
    rlens[5] = 40
    reads[5, 40:] = 4
    return reads, rlens


def batches(index):
    """The batch of pairs (outside the repeat copies), and the repeat batch:
    in each block of four reads one of those pairs, then a pair from the
    repeat copies, whose occurrences overrun the block's budget of 16."""
    jg, _, starts = index
    n = jg.two_genome_size
    in_repeat = np.zeros(n, bool)
    for a in starts:
        in_repeat[a:a + REPEAT] = in_repeat[n - a - REPEAT:n - a] = True
    span = RLEN + MATE_GAP
    rng = np.random.default_rng(6)
    unique = [p for p in rng.integers(0, n - span, 200) if not in_repeat[p:p + span].any()]
    s = np.array(unique[:8])
    pairs = pair_batch(jg, 8, 5, starts=s)
    s[1::2] = starts[rng.integers(0, N_COPIES, 4)] + rng.integers(0, REPEAT - span, 4)
    return {"pairs": pairs, "repeats": pair_batch(jg, 8, 7, starts=s)}


def jax_mesh(n_data, n_idx):
    return jdp.make_data_mesh(n_data, n_idx, devices=jax.devices("cpu"))


def torch_mesh(n_data, n_idx):
    return tdp.make_data_mesh(n_data, n_idx, devices=[CPU] * (n_data * n_idx))


SEED_MESHES = {"data1": (1, 1), "data8": (8, 1), "data2_idx4": (2, 4)}


@pytest.mark.parametrize("mesh", SEED_MESHES)
def test_mapping_step_matches_jax(index, mesh):
    jg, tg, _ = index
    n_data, n_idx = SEED_MESHES[mesh]
    reads, rlens = pair_batch(jg, 16, 3)
    kw = dict(idx_axis="idx" if n_idx > 1 else None, min_seed_len=MIN_SEED, max_seeds=MAX_SEEDS,
              l_max=RLEN)
    jstep, jplace = jdp.make_mapping_step(jax_mesh(n_data, n_idx), jg, **kw)
    want = [np.asarray(x) for x in jstep(*jplace(reads, rlens))]
    tstep, tplace = tdp.make_mapping_step(torch_mesh(n_data, n_idx), tg, **kw)
    got = tstep(*tplace(reads, rlens))
    assert_same(got, want, mesh)
    assert int(got[2]) > 0
    assert_same(tstep(reads, rlens), want, f"{mesh}, unplaced batch")


FULL_MESHES = {"data1_full": (1, 1, "full"), "data4_full": (4, 1, "full"),
               "data2_sampled": (2, 1, "sampled"), "data2_idx2_full": (2, 2, "full"),
               "data2_idx2_sampled": (2, 2, "sampled")}
_STEPS: dict = {}


def full_steps(index, mesh):
    """kart_tpu's and the port's full steps for one mesh, made once (one JAX
    compilation a mesh for both batches)."""
    if mesh not in _STEPS:
        jg, tg, _ = index
        n_data, n_idx, sa_mode = FULL_MESHES[mesh]
        kw = dict(idx_axis="idx" if n_idx > 1 else None, min_seed_len=MIN_SEED,
                  max_seeds=MAX_SEEDS, l_max=RLEN, sa_mode=sa_mode)
        _STEPS[mesh] = (jdp.make_full_mapping_step(jax_mesh(n_data, n_idx), jg, **kw),
                        tdp.make_full_mapping_step(torch_mesh(n_data, n_idx), tg, **kw))
    return _STEPS[mesh]


@pytest.mark.parametrize("batch", ["pairs", "repeats"])
@pytest.mark.parametrize("mesh", FULL_MESHES)
def test_full_mapping_step_matches_jax(index, mesh, batch):
    (jstep, jplace), (tstep, tplace) = full_steps(index, mesh)
    reads, rlens = batches(index)[batch]
    want = [np.asarray(x) for grp in jstep(*jplace(reads, rlens)) for x in grp]
    got = [x for grp in tstep(*tplace(reads, rlens)) for x in grp]
    assert_same(got, want, f"{mesh} {batch}")
    n_data = FULL_MESHES[mesh][0]
    flagged = want[0].reshape(n_data, -1) < 0
    if batch == "repeats":
        # each block's flagged reads are a suffix that starts at its repeat pair
        assert flagged.any()
        for row in flagged:
            assert not row[0] and list(row) == sorted(row)
    else:
        assert not flagged.any() and want[8].any()  # no flag, and some pair mated


def test_full_step_stream_per_read_is_the_single_device(index):
    """The data-4 stream is four blocks' streams, each read's entries those
    of the single-device run (the comparison the dry run makes)."""
    reads, rlens = batches(index)["pairs"]
    outs = {}
    for mesh in ("data1_full", "data4_full"):
        step, place = full_steps(index, mesh)[1]
        outs[mesh] = step(*place(reads, rlens))[0]
    for a, b in zip(tdp.per_read_entries(outs["data4_full"], 4),
                    tdp.per_read_entries(outs["data1_full"], 1)):
        assert torch.equal(a, b)


def test_per_read_entries_skips_a_flagged_reads_entries():
    """Two blocks of 3 reads and 8 entries each: read 1 was flagged while it
    fit (a walk cut at max_steps, cnts -3: 2 entries left in the stream), so
    read 2's entry comes after them; the flagged reads count 0."""
    cnts = torch.tensor([2, -3, 1, 0, 3, -1], dtype=torch.int32)
    meta = torch.tensor([10, 11, 12, 13, 14, -1, -1, -1, 20, 21, 22, -1, -1, -1, -1, -1],
                        dtype=torch.int32)
    gpos = meta.long() * 100
    counts, m, g = tdp.per_read_entries((cnts, meta, gpos), 2)
    assert counts.tolist() == [2, 0, 1, 0, 3, 0] and counts.dtype == torch.int32
    assert m.tolist() == [10, 11, 14, 20, 21, 22]
    assert torch.equal(g, m.long() * 100)
    keep = torch.tensor([False, False, True, True, True, False])
    counts, m, _ = tdp.per_read_entries((cnts, meta, gpos), 2, keep=keep)
    assert counts.tolist() == [0, 0, 1, 0, 3, 0] and m.tolist() == [14, 20, 21, 22]


REFUSALS = ("odd_block", "full_step_does_not_split", "seed_step_does_not_split",
            "index_past_int32", "idx_axis_of_a_1d_mesh", "mesh_past_the_cards",
            "entry_without_a_card", "dryrun_without_a_card")


@pytest.mark.parametrize("case", REFUSALS)
def test_refusals(index, case, monkeypatch):
    _, tg, _ = index
    reads, rlens = pair_batch(tg, 3, 1)  # 6 reads
    kw = dict(min_seed_len=MIN_SEED, max_seeds=MAX_SEEDS, l_max=RLEN)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    if case == "odd_block":
        step, place = tdp.make_full_mapping_step(torch_mesh(2, 1), tg, **kw)
        with pytest.raises(ValueError, match="must be even"):
            step(*place(reads, rlens))
    elif case in ("full_step_does_not_split", "seed_step_does_not_split"):
        make = tdp.make_full_mapping_step if case.startswith("full") else tdp.make_mapping_step
        step, place = make(torch_mesh(4, 1), tg, **kw)
        with pytest.raises(ValueError, match="does not split over 4 data rows"):
            step(reads, rlens)
    elif case == "index_past_int32":
        monkeypatch.setattr(TorchGenomeIndex, "two_genome_size", property(lambda self: 2**31))
        with pytest.raises(ValueError, match="fewer than 2\\*\\*31 text bases"):
            tdp.make_full_mapping_step(torch_mesh(1, 1), tg, **kw)
    elif case == "idx_axis_of_a_1d_mesh":
        with pytest.raises(ValueError, match="not an index axis"):
            tdp.make_mapping_step(torch_mesh(2, 1), tg, idx_axis="idx", **kw)
    elif case == "mesh_past_the_cards":
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(RuntimeError, match="needs 2 devices, only 1"):
            tdp.make_data_mesh(2)
        assert tdp.make_data_mesh(1).devices == ((torch.device("cuda", 0),),)
    elif case == "entry_without_a_card":
        with pytest.raises(RuntimeError, match="no CUDA device"):
            graft_entry.entry()
    else:
        with pytest.raises(RuntimeError, match="needs 1 devices, only 0"):
            graft_entry.dryrun_multichip(2)


def test_data_mesh_shape():
    m = torch_mesh(2, 4)
    assert m.axis_names == ("data", "idx") and m.shape == {"data": 2, "idx": 4}
    assert torch_mesh(8, 1).shape == dict(jax_mesh(8, 1).shape)
    assert m.shape == dict(jax_mesh(2, 4).shape)


# ---------------------------------------------------------------------------
# The entry points and the tools
# ---------------------------------------------------------------------------


def test_tiny_index_equals_root():
    want, got = root_entry._tiny_index(), graft_entry._tiny_index()
    for f in ("primary", "seq_len", "sa_intv", "l_pac", "chrom_names"):
        assert getattr(got.raw, f) == getattr(want.raw, f), f
    for f in ("L2", "occ_cp", "bwt_words", "sa_samples", "pac", "chrom_lens", "ann_offsets"):
        a, b = getattr(got.raw, f), getattr(want.raw, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for a, b in ((got.sa_full, want.sa_full), (got.chr_map[0], want.chr_map[0]),
                 (got.ref_codes, want.ref_codes)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_entry_equals_root():
    jfn, jargs = root_entry.entry()
    want = [np.asarray(x) for x in jax.jit(jfn)(*jargs)]
    fn, args = graft_entry.entry("cpu")
    assert_same(args, [np.asarray(x) for x in jargs], "example args")
    assert_same(fn(*args), want, "entry")


def test_dryrun_multichip_on_8_cpu_positions(capsys):
    graft_entry.dryrun_multichip(8, devices=[CPU] * 8)
    out = capsys.readouterr().out
    assert "[dryrun_multichip] ok: 8 devices, batch 32" in out
    assert "equal across single-device, 8x1 DP and 4x2 sharded-index meshes" in out


def json_lines(out: str):
    lines = out.splitlines()
    assert lines[0].startswith("# device cpu (cpu): every position of each mesh, up to 8, shares")
    return [json.loads(ln) for ln in lines[1:]]


def test_bench_scaling_cpu(monkeypatch, capsys):
    monkeypatch.setattr(bench_scaling, "BATCH", 256)
    assert bench_scaling.main(["--cpu"]) == 0
    recs = json_lines(capsys.readouterr().out)
    names = ["data=1", "data=2", "data=4", "data=8", "data=4,idx=2"]
    assert [r["config"] for r in recs] == names + names[1:]
    assert all(set(r) == {"config", "reads_per_sec"} and r["reads_per_sec"] > 0 for r in recs[:5])
    assert all(set(r) == {"config", "scaling_efficiency_vs_1"} for r in recs[5:])


def test_scaling_curve_cpu_quick(capsys):
    assert scaling_curve.main(["--cpu", "--quick"]) == 0
    recs = json_lines(capsys.readouterr().out)
    assert [r["mesh"] for r in recs] == ["data=1", "data=2", "data=4", "data=8",
                                         "data=4 x idx=2"]
    assert all(set(r) == {"mesh", "reads_per_sec", "step_ms", "rel_vs_1shard", "seeds"}
               for r in recs)
    assert len({r["seeds"] for r in recs}) == 1 and recs[0]["rel_vs_1shard"] == 1.0


@pytest.mark.parametrize("tool", ["bench_scaling", "scaling_curve"])
def test_scaling_tools_refuse_without_cuda(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = {"bench_scaling": bench_scaling.main, "scaling_curve": scaling_curve.main}[tool]
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(["--quick"] if tool == "scaling_curve" else [])
