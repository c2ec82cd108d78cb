"""The cross-device FastMode scan around the fused step, against kart_tpu.

kart_tpu_torch/parallel/sharded_index.py steps the scan of an index whose
shards span several devices on the first shard's device: every other group
of shards looks both interval ends of every lane up (G1, into a part there),
and one fused step adds the stepping group's own lookup and the parts and
takes the FastMode step (csrc/sharded_fm.cu's sharded_fused_step_kernel; its
plain version `fused_step_plain`).  The loop's plain version
(`_stepwise_seed_scan(..., plain=True)`) is held here against kart_tpu's
sharded_seed_scan inside shard_map on the forced host devices at 2, 4 and 8
shards, in 1, 2 and 4 groups, at int32 and int64, on batches with pad,
short and all-N lanes, Ns and the texts around `primary`, and against the
replicated plain scan; and a step is counted: N - 1 group lookups and the
fused step for N groups.  The wrappers refuse CPU tensors (no fallback)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from kart_tpu.index import build_index, load_index
from kart_tpu.parallel import dp as jdp
from kart_tpu.parallel import sharded_index as jsi
from kart_tpu_torch import kernels
from kart_tpu_torch.ops import fm_search as tfm
from kart_tpu_torch.parallel import sharded_index as tsi

from conftest import make_genome
from test_torch_host_shim import fm_edge_reads, fm_index
from test_torch_parallel import as_dtype

torch.set_num_threads(1)
MIN_SEED = 13
L_MAX = 80
MAX_SEEDS = 1  # fewer slots than some reads' seeds
CASES = [(n, g) for n in (2, 4, 8) for g in (1, 2, 4) if g <= n]


@pytest.fixture(scope="module")
def index(workdir):
    """A 20 kb two-chromosome genome with N runs, in a number of blocks that
    8 does not divide."""
    fa = workdir / "torch_walk_step.fa"
    fa.write_text(make_genome(np.random.default_rng(41), [12000, 8032], n_runs=2))
    prefix = workdir / "torch_walk_step_idx"
    build_index(str(fa), str(prefix), verbose=False)
    gidx = load_index(str(prefix))
    assert np.asarray(gidx.device_arrays["occ_cp"]).shape[0] % 8
    return gidx


def scan_batch(gidx):
    """fm_edge_reads' lanes (pad, short, exactly the minimal seed, all-N, Ns
    first, last and in a run, the texts around `primary`) and 40 reads of
    the genome as phase 2 cuts them, every third with a mismatch, one with
    an N: (reads (B, L_MAX) int32, rlens (B,) int32)."""
    rng = np.random.default_rng(12)
    starts = rng.integers(0, gidx.two_genome_size - L_MAX, 40)
    reads = gidx.ref_codes[starts[:, None] + np.arange(L_MAX)].astype(np.int32)
    reads[::3, 33] = (reads[::3, 33] + 1) % 4
    reads[7, 50] = 4
    edges, edge_lens = fm_edge_reads(gidx, L_MAX)
    return (torch.from_numpy(np.concatenate([edges, reads])),
            torch.from_numpy(np.concatenate([edge_lens, np.full(40, L_MAX, np.int32)])))


_JAX: dict = {}


def jax_scan(gidx, n, dtype):
    """kart_tpu's sharded_seed_scan on an `idx` mesh of n host devices
    (numpy, cached)."""
    key = (n, dtype)
    if key not in _JAX:
        jax.config.update("jax_enable_x64", dtype == "int64")
        try:
            reads, rlens = scan_batch(gidx)
            sfm_host, geom = jsi.build_sharded_fm(as_dtype(gidx, dtype), n)
            mesh = Mesh(np.array(jax.devices("cpu")[:n]), ("idx",))
            sfm = jdp.place_sharded_fm(sfm_host, mesh, "idx")

            def local(s, r, rl):
                return jsi.sharded_seed_scan(s, geom["nb_local"], "idx", r, rl,
                                             np.int32(MIN_SEED), max_seeds=MAX_SEEDS, l_max=L_MAX)

            fn = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(jdp.ShardedFMSpecs("idx"), P(),
                                                                   P()), out_specs=P()))
            _JAX[key] = np.asarray(fn(sfm, jnp.asarray(reads.numpy()),
                                      jnp.asarray(rlens.numpy())))
        finally:
            jax.config.update("jax_enable_x64", False)
    return _JAX[key]


def split_groups(sfm, g):
    """The shards in g contiguous groups (the first with shard 0)."""
    n = len(sfm.shards)
    return [sfm.shards[i * n // g:(i + 1) * n // g] for i in range(g)]


@pytest.mark.parametrize("dtype", ["int32", "int64"])
@pytest.mark.parametrize("n, g", CASES)
def test_fused_scan_plain_matches_jax(index, n, g, dtype):
    """The cross-device scan's plain version (own lookup, the other groups'
    parts, the step) equals kart_tpu's sharded_seed_scan and the replicated
    plain scan, seeds past max_seeds dropped and counted."""
    sfm = tsi.build_sharded_fm(as_dtype(index, dtype), ["cpu"] * n, "full")
    reads, rlens = scan_batch(index)
    kw = dict(max_seeds=MAX_SEEDS, l_max=L_MAX)
    got = tsi._stepwise_seed_scan(sfm, reads, rlens, MIN_SEED, **kw, groups=split_groups(sfm, g),
                                  plain=True)
    want = jax_scan(index, n, dtype)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, tfm.seed_scan_plain(fm_index(index, dtype), reads, rlens, MIN_SEED,
                                                **kw))
    assert (got[:, 0] > MAX_SEEDS).any() and (got[:, 0] == 0).any()


@pytest.mark.parametrize("g", [1, 2, 4])
def test_fused_scan_step_counts(index, g, monkeypatch):
    """A step of the cross-device scan in g groups is g - 1 group lookups and
    one fused step (whose own lookup is the stepping group's): counted by
    wrapping the plain functions, over l_max + 1 steps; the seeds are the
    unwrapped loop's."""
    sfm = tsi.build_sharded_fm(index, ["cpu"] * 4, "full")
    reads, rlens = scan_batch(index)
    groups = split_groups(sfm, g)
    kw = dict(max_seeds=MAX_SEEDS, l_max=L_MAX)
    want = tsi._stepwise_seed_scan(sfm, reads, rlens, MIN_SEED, **kw, groups=groups, plain=True)
    calls = dict(lookup=0, own=0, fused=0)
    inside = [False]
    occ4, fused = tsi.table_occ4_plain, tsi.fused_step_plain

    def counted_occ4(s, shards, k):
        calls["own" if inside[0] else "lookup"] += 1
        return occ4(s, shards, k)

    def counted_fused(s, shards, *a):
        assert shards is groups[0]
        calls["fused"] += 1
        inside[0] = True
        try:
            return fused(s, shards, *a)
        finally:
            inside[0] = False

    monkeypatch.setattr(tsi, "table_occ4_plain", counted_occ4)
    monkeypatch.setattr(tsi, "fused_step_plain", counted_fused)
    got = tsi._stepwise_seed_scan(sfm, reads, rlens, MIN_SEED, **kw, groups=groups, plain=True)
    assert torch.equal(got, want)
    steps = L_MAX + 1
    assert calls == dict(lookup=(g - 1) * steps, own=steps, fused=steps)


def test_fused_step_wrapper_refuses_cpu_tensors(index):
    """kernels.sharded_fused_step raises on CPU tensors (the loop takes the
    plain version there; the wrapper never does), and part_pointers of no
    parts is None."""
    sfm = tsi.build_sharded_fm(index, ["cpu"] * 2, "full")
    B = 4
    state, out, k = tfm.seed_scan_state(B, MAX_SEEDS, sfm.index_dtype, "cpu")
    table = torch.zeros((2, 3), dtype=torch.int64)
    codes_t = torch.zeros((L_MAX, B), dtype=torch.int32)
    rlens = torch.full((B,), L_MAX, dtype=torch.int32)
    with pytest.raises(ValueError, match="cuda"):
        kernels.sharded_fused_step(table, sfm.nb_local, sfm.L2, sfm.primary, sfm.seq_len, k, [],
                                   None, 0, codes_t, rlens, MIN_SEED, MAX_SEEDS, state, state, out,
                                   k.clone())
    assert kernels.part_pointers([]) is None


def test_flat_kernels_refuse_an_index_past_32_bit_blocks(index):
    """The flat index's kernels take 32-bit block numbers: an index of 2**39
    text rows or more is refused before any launch."""
    fm = tfm.FMIndexTensors.from_genome_index(index, "cpu")
    big = tfm.FMIndexTensors(occ_cp=fm.occ_cp, bwt_words=fm.bwt_words, sa_samples=fm.sa_samples,
                             L2=fm.L2, primary=fm.primary, seq_len=kernels.FLAT_MAX_TEXT)
    with pytest.raises(ValueError, match="2\\*\\*39"):
        kernels.sa_walk(big, torch.zeros(3, dtype=torch.int32))
