"""The sharded index's owner-select lookups and its resident scan and walk
against kart_tpu's sharded functions.

kart_tpu_torch/parallel/sharded_index.py reads the shards of a device
through a shard table: the owner-select occ4 and inverse-Psi step of a set of
shards (G1 and G3 of the cross-device path), and, where one device holds
every shard, the whole FastMode scan and the whole sampled-SA walk as
resident loops.  Their plain versions are held here against kart_tpu's
sharded functions inside shard_map on the forced host devices (the cached
results of tests/test_torch_parallel.py's jax_ops), at N in {1, 2, 3, 8} and
in the int32 and int64 index dtypes, exactly: occ4 of a batch and of a pair,
the scan's packed seeds, the walk (whole, and cut at 8 steps) and the
resolved stream through the full SA and through the walk.  Each op runs two
ways: resident (every shard in one group) and the cross-device formulation
with the shards split into two groups on the CPU, which must equal the
resident one.  Then the shard table and the refusals: a resident call on
shards spread over devices, and a shard on an unsupported device.

G4 and the resident full-SA resolve run as host C++ through
tests/host_shim (csrc/sharded_fm.cu and csrc/resolve_pack.cu): the table
gather at 1, 2 and 4 shards, every shard in one table and in two groups,
the full SA and the samples, against its plain composition
(shard_gather_plain of each shard, summed) and against kart_tpu's masked
gather with its psum; resolve_pack.cu's passes reading the positions
through the table of every shard against resolve_pack's plain version on
the flat full SA and against kart_tpu's sharded_seed_scan_resolved."""

import ctypes
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import kart_tpu_torch
from kart_tpu.index import build_index, load_index
from kart_tpu.parallel import dp as jdp
from kart_tpu.parallel import sharded_index as jsi
from kart_tpu_torch import kernels
from kart_tpu_torch.ops import resolve as tres
from kart_tpu_torch.parallel import dp as tdp
from kart_tpu_torch.parallel import sharded_index as tsi

from conftest import make_genome
from host_shim import translate
from test_torch_parallel import (B, L_MAX, MAX_SEEDS, MIN_SEED, BUDGET, N_SHARDS, as_dtype,
                                 jax_ops, op_inputs)

torch.set_num_threads(1)
OPS = ("occ4_batch", "occ4_pair", "seed_scan", "sa_walk", "sa_walk_cut", "resolved_full",
       "resolved_sampled")
SPLITS = ("resident", "two_groups")


@pytest.fixture(scope="module")
def index(workdir):
    """test_torch_parallel.py's genome (the same bytes, so jax_ops' cache
    holds either file's results), indexed under names of this file's own:
    the two files may run at once in separate workers."""
    fa = workdir / "torch_sharded_table.fa"
    fa.write_text(make_genome(np.random.default_rng(31), [14000, 10068], n_runs=2))
    prefix = workdir / "torch_sharded_table_idx"
    build_index(str(fa), str(prefix), verbose=False)
    gidx = load_index(str(prefix))
    nb = np.asarray(gidx.device_arrays["occ_cp"]).shape[0]
    assert nb % 3 and nb % 8  # the last slab is padded
    return gidx


def groups_of(sfm, split):
    """Every shard in one group, or the first half (with shard 0) and the
    rest."""
    if split == "resident":
        return [sfm.shards]
    half = (len(sfm.shards) + 1) // 2
    return [g for g in (sfm.shards[:half], sfm.shards[half:]) if g]


def table_op(gidx, n, dtype, op, split, monkeypatch):
    """One op through the owner-select plain versions, n shards on the CPU,
    grouped by `split`."""
    inp = {k: torch.from_numpy(v) for k, v in op_inputs(gidx, dtype).items()}
    sfm = tsi.build_sharded_fm(as_dtype(gidx, dtype), ["cpu"] * n,
                               "sampled" if op == "resolved_sampled" else "full")
    groups = groups_of(sfm, split)
    kw = dict(max_seeds=MAX_SEEDS, l_max=L_MAX)
    if op == "occ4_batch":
        return tsi.combine([tsi.table_occ4_plain(sfm, g, inp["k"]) for g in groups], sfm.device)
    if op == "occ4_pair":
        both = torch.cat([inp["ka"], inp["kb"]])
        cnt = tsi.combine([tsi.table_occ4_plain(sfm, g, both) for g in groups], sfm.device)
        return cnt[:len(inp["ka"])], cnt[len(inp["ka"]):]
    if op == "seed_scan":
        if split == "resident":
            return tsi.resident_seed_scan_plain(sfm, inp["reads"], inp["rlens"], MIN_SEED, **kw)
        return tsi._stepwise_seed_scan(sfm, inp["reads"], inp["rlens"], MIN_SEED, **kw,
                                       groups=groups)
    if op in ("sa_walk", "sa_walk_cut"):
        steps = 8 if op == "sa_walk_cut" else 4096
        if split == "resident":
            return tsi.resident_sa_walk_plain(sfm, inp["rows"], max_steps=steps)
        return tsi._stepwise_sa_walk(sfm, inp["rows"], max_steps=steps, groups=groups)
    # the resolved stream: the whole path, its grouping forced
    monkeypatch.setattr(tsi, "shard_groups", lambda s: groups_of(s, split))
    return tsi.sharded_seed_scan_resolved(sfm, inp["reads"], inp["rlens"], MIN_SEED,
                                          occ_budget=BUDGET, **kw)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("dtype", ["int32", "int64"])
@pytest.mark.parametrize("n", N_SHARDS)
@pytest.mark.parametrize("op", OPS)
def test_table_op_matches_jax(index, op, n, dtype, split, monkeypatch):
    want = jax_ops(index, n, dtype)[op]
    got = table_op(index, n, dtype, op, split, monkeypatch)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.numpy().dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g.numpy(), w)
    if op == "sa_walk_cut":
        assert 0 < int((~got[1]).sum()) < len(got[1])  # rows that hit max_steps
    if op == "resolved_full":
        assert 0 < int((got[0] < 0).sum()) < B  # reads past the budget are flagged


@pytest.mark.parametrize("dtype", ["int32", "int64"])
@pytest.mark.parametrize("n", N_SHARDS)
def test_table_lookups_answer_only_their_shards(index, n, dtype):
    """Each shard's owner-select occ4 and inverse-Psi step answer the rows
    it owns, zeros elsewhere, and every row has one owner: over single-shard
    groups, a row is nonzero in at most one part and the parts sum to the
    whole table's answer; the first group's step counts every row not at a
    sample once."""
    sfm = tsi.build_sharded_fm(as_dtype(index, dtype), ["cpu"] * n, "sampled")
    rows = torch.from_numpy(op_inputs(index, dtype)["rows"])
    occ = [tsi.table_occ4_plain(sfm, [s], rows) for s in sfm.shards]
    assert int(torch.stack([o.any(dim=1) for o in occ]).sum(dim=0).max()) <= 1
    assert torch.equal(sum(occ), tsi.table_occ4_plain(sfm, sfm.shards, rows))
    add = torch.zeros(rows.shape[0], dtype=torch.int32)
    step = tsi.sharded_inv_psi_batch(sfm, rows, add, groups=[[s] for s in sfm.shards])
    assert torch.equal(step, tsi.table_inv_psi_plain(sfm, sfm.shards, rows))
    assert torch.equal(add, ((rows & 31) != 0).to(torch.int32))


def test_shard_table_rows_and_cache(index):
    """A table has a row for every shard of the index, the slab pointers of
    the shards in the group (occ_cp, bwt_words, sa_samples, and sa_full,
    null in the sampled SA mode) and zeros elsewhere; it is made once per
    ShardedFM and set of slabs, and an index placed anew gets its own."""
    sfm = tsi.build_sharded_fm(index, ["cpu"] * 3, "sampled")
    groups = groups_of(sfm, "two_groups")
    t = tsi.shard_table(sfm, groups[1])
    assert t.dtype == torch.int64 and tuple(t.shape) == (3, 4)
    assert not t[0].any() and not t[1].any()
    s2 = sfm.shards[2]
    assert t[2].tolist() == [s2.occ_cp.data_ptr(), s2.bwt_words.data_ptr(),
                             s2.sa_samples.data_ptr(), 0]
    assert not t.has_full_sa
    assert tsi.shard_table(sfm, groups[1]) is t
    assert tsi.shard_table(sfm, sfm.shards) is not t and len(sfm.tables) == 2
    placed = tdp.place_sharded_fm(sfm, ["cpu"] * 3)
    assert placed.tables == {}
    assert tsi.shard_groups(placed) == [placed.shards]
    full = tsi.build_sharded_fm(index, ["cpu"] * 3, "full")
    tf = tsi.shard_table(full, full.shards)
    assert tf[:, 3].tolist() == [s.sa_full.data_ptr() for s in full.shards]
    assert tf.has_full_sa and tf.every_shard


def test_resident_and_unsupported_devices_raise(index):
    """No fallback: a resident call on shards that are not all on its
    device, a shard on a device of no supported kind, and a kernel given CPU
    tensors each raise."""
    sfm = tsi.build_sharded_fm(index, ["cpu"] * 2, "sampled")
    shards = [sfm.shards[0], dataclasses.replace(
        sfm.shards[1], occ_cp=sfm.shards[1].occ_cp.to("meta"),
        bwt_words=sfm.shards[1].bwt_words.to("meta"),
        sa_samples=sfm.shards[1].sa_samples.to("meta"), L2=sfm.shards[1].L2.to("meta"))]
    mixed = dataclasses.replace(sfm, shards=shards)
    assert [len(g) for g in tsi.shard_groups(mixed)] == [1, 1]
    inp = op_inputs(index, "int32")
    reads, rlens = torch.from_numpy(inp["reads"]), torch.from_numpy(inp["rlens"])
    rows = torch.from_numpy(inp["rows"])
    with pytest.raises(ValueError, match="a resident call"):
        tsi.resident_seed_scan(mixed, reads, rlens, MIN_SEED, max_seeds=MAX_SEEDS, l_max=L_MAX)
    with pytest.raises(ValueError, match="a resident call"):
        tsi.resident_sa_walk(mixed, rows)
    with pytest.raises(ValueError, match="unsupported device meta"):
        tsi.sharded_seed_scan(mixed, reads, rlens, MIN_SEED, max_seeds=MAX_SEEDS, l_max=L_MAX)
    with pytest.raises(ValueError, match="unsupported device meta"):
        tsi.sharded_sa_walk(mixed, rows)
    with pytest.raises(ValueError, match="shard 1 on meta"):
        tsi.shard_table(mixed, mixed.shards)
    table = tsi.shard_table(sfm, sfm.shards)
    for call in (lambda: kernels.sharded_seed_scan(table, sfm.nb_local, sfm.L2, sfm.primary,
                                                   sfm.seq_len, reads, rlens, MIN_SEED,
                                                   max_seeds=MAX_SEEDS, l_max=L_MAX),
                 lambda: kernels.sharded_sa_walk(table, sfm.nb_local, sfm.nsamp_local, sfm.L2,
                                                 sfm.primary, sfm.seq_len, rows),
                 lambda: kernels.sharded_occ4(table, sfm.nb_local, sfm.L2, sfm.primary,
                                              sfm.seq_len, rows),
                 lambda: kernels.sharded_inv_psi(table, sfm.nb_local, sfm.L2, sfm.primary,
                                                 sfm.seq_len, rows)):
        with pytest.raises(ValueError, match="expected a cuda tensor"):
            call()


@pytest.mark.parametrize("n, cards", [(2, 1), (4, 1), (8, 4), (8, 3), (3, 8), (4, 4)])
def test_default_layout_puts_contiguous_shards_on_each_card(n, cards, monkeypatch):
    """-idx-shards N on C cards: one shard a card where N <= C, else
    contiguous runs of N // C or N // C + 1 shards on every card, shard 0 on
    cuda:0; on one card every shard shares cuda:0, which is the resident
    path's layout."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    devs = tsi.default_shard_devices(n, "cuda")
    idx = [d.index for d in devs]
    assert len(devs) == n and {d.type for d in devs} == {"cuda"}
    assert idx == sorted(idx) and idx[0] == 0
    assert set(idx) == set(range(min(n, cards)))
    runs = [idx.count(c) for c in set(idx)]
    assert max(runs) - min(runs) <= 1
    if cards == 1:
        assert idx == [0] * n


@pytest.mark.parametrize("kernel", ["sharded_seed_scan", "sharded_sa_walk"])
def test_resident_kernels_refuse_a_partial_table(index, kernel):
    """A resident kernel reads every row of its table: a group's table, with
    null rows for the other shards, raises before any launch, and only the
    table of every shard is marked whole."""
    sfm = tsi.build_sharded_fm(index, ["cpu"] * 3, "sampled")
    part = tsi.shard_table(sfm, sfm.shards[:2])
    assert not part.every_shard and tsi.shard_table(sfm, sfm.shards).every_shard
    inp = op_inputs(index, "int32")
    args = {"sharded_seed_scan": (sfm.nb_local, sfm.L2, sfm.primary, sfm.seq_len,
                                  torch.from_numpy(inp["reads"]), torch.from_numpy(inp["rlens"]),
                                  MIN_SEED),
            "sharded_sa_walk": (sfm.nb_local, sfm.nsamp_local, sfm.L2, sfm.primary, sfm.seq_len,
                                torch.from_numpy(inp["rows"]))}[kernel]
    kw = dict(max_seeds=MAX_SEEDS, l_max=L_MAX) if kernel == "sharded_seed_scan" else {}
    with pytest.raises(ValueError, match="a table of every shard"):
        getattr(kernels, kernel)(part, *args, **kw)


# ---------------------------------------------------------------------------
# G4 and the resident full-SA resolve through the host shim
# ---------------------------------------------------------------------------

GATHER_SHARDS = (1, 2, 4)


@pytest.fixture(scope="module")
def shim_lib(tmp_path_factory):
    """csrc/sharded_fm.cu and csrc/resolve_pack.cu compiled as host C++."""
    so = tmp_path_factory.mktemp("host_shim_table") / "libtable.so"
    csrc = os.path.join(os.path.dirname(os.path.abspath(kart_tpu_torch.__file__)), "csrc")
    translate.build(str(so), [os.path.join(csrc, f) for f in ("sharded_fm.cu", "resolve_pack.cu")])
    lib = ctypes.CDLL(str(so))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for sfx in ("", "_i64"):
        getattr(lib, "kart_sharded_gather" + sfx).argtypes = [p, i, ll, p, i, i, p, p]
    lib.kart_resolve_pack_table.argtypes = [p, i, i, p, i, ll, i, p, p, p, p, p]
    lib.kart_resolve_rows_table_i64.argtypes = [p, i, i, p, i, ll, i, p, p, p, p, p, p]
    lib.kart_resolve_finish_i64.argtypes = [p, i, i, i, i, p, p, p, p, p, p, p]
    lib.kart_resolve_scan_words.argtypes = [i]
    return lib


def ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def jax_gathers(gidx, n, dtype, rows):
    """kart_tpu's masked gathers with their psum on an `idx` mesh of n host
    devices: sharded_sa_gather of the full SA at rows, and the same of the
    samples at rows >> 5 (the gather at the end of its sharded walk)."""
    jax.config.update("jax_enable_x64", dtype == "int64")
    try:
        sfm_host, geom = jsi.build_sharded_fm(as_dtype(gidx, dtype), n)
        mesh = Mesh(np.array(jax.devices("cpu")[:n]), ("idx",))
        sfm = jdp.place_sharded_fm(sfm_host, mesh, "idx")

        def local(s, r):
            return (jsi.sharded_sa_gather(s.sa_full, geom["ns_local"], "idx", r),
                    jsi.sharded_sa_gather(s.sa_samples, geom["nsamp_local"], "idx", r >> 5))

        fn = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(jdp.ShardedFMSpecs("idx"), P()),
                                   out_specs=P()))
        return [np.asarray(x) for x in fn(sfm, jnp.asarray(rows))]
    finally:
        jax.config.update("jax_enable_x64", False)


def host_table_gather(lib, sfm, shards, rows, shift):
    """G4 through the host shim with the table of `shards`; its output
    starts as garbage."""
    r = np.ascontiguousarray(rows.numpy())
    out = np.full(len(r), -7, r.dtype)
    table = tsi.shard_table(sfm, shards)
    sfx = "" if r.dtype == np.int32 else "_i64"
    rc = getattr(lib, "kart_sharded_gather" + sfx)(
        table.data_ptr(), table.shape[0], sfm.ns_local if shift == 0 else sfm.nsamp_local, ptr(r),
        len(r), shift, ptr(out), None)
    assert rc == 0
    return torch.from_numpy(out)


@pytest.mark.parametrize("shift", [0, 5])
@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("dtype", ["int32", "int64"])
@pytest.mark.parametrize("n", GATHER_SHARDS)
def test_table_gather_kernel_on_host_matches_plain_and_jax(index, shim_lib, n, dtype, split,
                                                           shift):
    """G4, one launch a group through its table: each group's gather equal
    to its plain composition, the groups' sum to kart_tpu's gather (the full
    SA, or the samples at rows >> 5) and to the port's sharded_sa_gather; a
    row past the index and row 0 included."""
    idt = np.int32 if dtype == "int32" else np.int64
    rows_np = np.concatenate([[0, int(index.seq_len)], op_inputs(index, dtype)["rows"]]).astype(idt)
    rows = torch.from_numpy(rows_np)
    sfm = tsi.build_sharded_fm(as_dtype(index, dtype), ["cpu"] * n, "full")
    parts = []
    for g in groups_of(sfm, split):
        got = host_table_gather(shim_lib, sfm, g, rows, shift)
        assert torch.equal(got, tsi.table_gather_plain(sfm, g, rows, shift))
        assert torch.equal(got, tsi.combine([tsi.shard_gather_plain(slab, lo, rows, shift)
                                             for slab, lo in tsi._gather_slabs(sfm, g, shift)],
                                            sfm.device))
        parts.append(got)
    got = tsi.combine(parts, sfm.device).numpy()
    want = jax_gathers(index, n, dtype, rows_np)[0 if shift == 0 else 1]
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if shift == 0:
        np.testing.assert_array_equal(got, tsi.sharded_sa_gather(sfm, rows).numpy())
        np.testing.assert_array_equal(got, tsi.resident_sa_gather_plain(sfm, rows).numpy())


def host_resident_resolve(lib, sfm, packed, H):
    """resolve_pack.cu through the table of every shard, through the host
    shim, as kernels.resolve_stream_table makes the calls: (cnts, meta,
    gpos); the outputs and scratch start as garbage."""
    pk = np.ascontiguousarray(packed.numpy())
    Bn = pk.shape[0]
    table = tsi.shard_table(sfm, sfm.shards)
    read_end, cnts = np.full(Bn, -7, np.int32), np.full(Bn, -7, np.int32)
    state = np.zeros(lib.kart_resolve_scan_words(Bn), np.int64)
    tab = (ptr(pk), Bn, MAX_SEEDS, table.data_ptr(), table.shape[0], sfm.ns_local, H)
    if pk.dtype == np.int32:
        out = np.full(Bn + 2 * H, -7, np.int32)
        assert lib.kart_resolve_pack_table(*tab, ptr(read_end), ptr(cnts), ptr(state), ptr(out),
                                           None) == 0
        return out[:Bn], out[Bn:Bn + H], out[Bn + H:]
    out = np.full(Bn + H, -7, np.int32)
    gpos, slot_read = np.full(H, -7, np.int64), np.full(H, -7, np.int32)
    assert lib.kart_resolve_rows_table_i64(*tab, ptr(read_end), ptr(cnts), ptr(state),
                                           ptr(slot_read), ptr(gpos), None) == 0
    assert lib.kart_resolve_finish_i64(ptr(pk), Bn, 0, MAX_SEEDS, H, ptr(read_end), ptr(cnts),
                                       ptr(slot_read), None, ptr(gpos), ptr(out), None) == 0
    return out[:Bn], out[Bn:], gpos


@pytest.mark.parametrize("dtype", ["int32", "int64"])
@pytest.mark.parametrize("n", N_SHARDS)
def test_resident_resolve_kernel_on_host_matches_flat_and_jax(index, shim_lib, n, dtype):
    """The resident full-SA resolve: resolve_pack.cu's passes with each
    position read from its owner's slab through the table of every shard
    (int32: totals and emit; int64: totals, rows, emit) equal to
    resolve_pack's plain version on the flat full SA and to kart_tpu's
    sharded_seed_scan_resolved, reads past the budget flagged."""
    inp = {k: torch.from_numpy(v) for k, v in op_inputs(index, dtype).items()}
    g = as_dtype(index, dtype)
    sfm = tsi.build_sharded_fm(g, ["cpu"] * n, "full")
    packed = tsi.resident_seed_scan_plain(sfm, inp["reads"], inp["rlens"], MIN_SEED,
                                          max_seeds=MAX_SEEDS, l_max=L_MAX)
    got = host_resident_resolve(shim_lib, sfm, packed, BUDGET)
    flat = tres.resolve_pack_plain(torch.from_numpy(np.asarray(g.sa_full)), packed,
                                   max_seeds=MAX_SEEDS, has_ok=False, occ_budget=BUDGET,
                                   pack16=False)
    if not isinstance(flat, tuple):
        flat = flat[:B], flat[B:B + BUDGET], flat[B + BUDGET:]
    want = jax_ops(index, n, dtype)["resolved_full"]
    for a, f, w in zip(got, flat, want):
        np.testing.assert_array_equal(a, f.numpy())
        assert a.dtype == w.dtype
        np.testing.assert_array_equal(a, w)
    assert 0 < int((got[0] < 0).sum()) < B


OWNER_PROBE = """#include "%s"
extern "C" void probe_owner(const unsigned long long* q, int n, unsigned long long d, int wide,
                            unsigned long long* out) {
  ShardedSa<long long> a;
  ShardedSa<int> b;
  a.set_rows(d);
  b.set_rows(d);
  for (int i = 0; i < n; ++i) out[i] = wide ? a.owner(q[i]) : b.owner(q[i]);
}
"""


@pytest.mark.parametrize("wide", [False, True])
def test_table_gather_owner_is_the_quotient(tmp_path, wide):
    """ShardedSa's owner of row q, q / n_local by a multiply by the
    reciprocal: exact in one step for 32-bit rows and slabs (int32), and
    in two (the multiply, then a correction) for an int64 index's rows up
    to 2**37 and slabs of any size, divisors of 2**64 and d = 1 included;
    the host shim's __umul64hi is the card's."""
    csrc = os.path.join(os.path.dirname(os.path.abspath(kart_tpu_torch.__file__)), "csrc")
    src = tmp_path / "owner.cu"
    src.write_text(OWNER_PROBE % os.path.join(csrc, "fm_index.cuh"))
    so = tmp_path / "libowner.so"
    translate.build(str(so), [str(src)])
    lib = ctypes.CDLL(str(so))
    lib.probe_owner.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong, ctypes.c_int,
                                ctypes.c_void_p]
    rng = np.random.default_rng(3)
    top = 1 << (37 if wide else 31)
    ds = [1, 2, 3, 7, 1 << 20, (1 << 31) - 1] + list(rng.integers(2, top, 40))
    if wide:
        ds += [(1 << 32) + 1, 1 << 36, (1 << 37) - 1]
    for d in ds:
        d = int(d)
        q = np.concatenate([rng.integers(0, top, 2000), [0, top - 1],
                            np.arange(1, 6) * d - 1, np.arange(0, 5) * d]).astype(np.uint64)
        q = q[q < top]
        out = np.zeros_like(q)
        lib.probe_owner(q.ctypes.data, len(q), d, int(wide), out.ctypes.data)
        np.testing.assert_array_equal(out, q // np.uint64(d), err_msg=f"d {d}")


def test_table_kernels_refuse_what_they_cannot_take(index):
    """The resident resolve needs the table of every shard with its full-SA
    slabs (a sampled index's table, or a group's, raises before any build or
    launch); the table gather takes shift 0 or 5 only."""
    sampled = tsi.build_sharded_fm(index, ["cpu"] * 2, "sampled")
    full = tsi.build_sharded_fm(index, ["cpu"] * 2, "full")
    packed = torch.zeros((4, 1 + 4 * MAX_SEEDS), dtype=torch.int32)
    for table in (tsi.shard_table(sampled, sampled.shards), tsi.shard_table(full, full.shards[:1])):
        with pytest.raises(ValueError, match="full-SA slab"):
            kernels.resolve_stream_table(table, full.ns_local, packed, max_seeds=MAX_SEEDS,
                                         occ_budget=8)
    rows = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="shift 3"):
        kernels.sharded_gather(tsi.shard_table(full, full.shards), full.ns_local, rows, 3)
    with pytest.raises(ValueError, match="expected a cuda tensor"):
        kernels.sharded_gather(tsi.shard_table(full, full.shards), full.ns_local, rows, 0)
