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
shards spread over devices, and a shard on an unsupported device."""

import dataclasses

import numpy as np
import pytest
import torch

from kart_tpu.index import build_index, load_index
from kart_tpu_torch import kernels
from kart_tpu_torch.parallel import dp as tdp
from kart_tpu_torch.parallel import sharded_index as tsi

from conftest import make_genome
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
    the shards in the group and zeros elsewhere; it is made once per
    ShardedFM and set of slabs, and an index placed anew gets its own."""
    sfm = tsi.build_sharded_fm(index, ["cpu"] * 3, "sampled")
    groups = groups_of(sfm, "two_groups")
    t = tsi.shard_table(sfm, groups[1])
    assert t.dtype == torch.int64 and tuple(t.shape) == (3, 3)
    assert not t[0].any() and not t[1].any()
    s2 = sfm.shards[2]
    assert t[2].tolist() == [s2.occ_cp.data_ptr(), s2.bwt_words.data_ptr(),
                             s2.sa_samples.data_ptr()]
    assert tsi.shard_table(sfm, groups[1]) is t
    assert tsi.shard_table(sfm, sfm.shards) is not t and len(sfm.tables) == 2
    placed = tdp.place_sharded_fm(sfm, ["cpu"] * 3)
    assert placed.tables == {}
    assert tsi.shard_groups(placed) == [placed.shards]


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
