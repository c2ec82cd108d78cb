"""The port's occurrence expansion and full-SA resolution against kart_tpu's
`expand_resolve` and `decode_resolved_counts` (`kart_tpu/ops/resolve.py`),
exactly, with dtypes asserted (int32 throughout: no int64 from cumsum)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kart_tpu.ops import pack as jpack
from kart_tpu.ops import resolve as jres
from kart_tpu_torch.ops import pack as tpack
from kart_tpu_torch.ops import resolve as tres

torch.set_num_threads(1)


def seed_blocks(rng, B, S, n_sa):
    n_seeds = rng.integers(0, S + 1, B).astype(np.int32)  # n_seeds < S on most rows
    rpos = rng.integers(0, 150, (B, S)).astype(np.int32)
    slen = rng.integers(13, 151, (B, S)).astype(np.int32)
    freq = rng.integers(0, 6, (B, S)).astype(np.int32)
    k0 = rng.integers(0, n_sa - 6, (B, S)).astype(np.int32)
    ok_in = rng.random(B) < 0.8
    return n_seeds, rpos, slen, k0, freq, ok_in


def run_both(sa, blocks, H):
    jsa = jnp.asarray(sa)
    want = jres.expand_resolve(lambda rows: (jsa[rows], rows == rows),
                               *map(jnp.asarray, blocks), occ_budget=H)
    got = tres.expand_resolve_plain(torch.from_numpy(sa), *map(torch.from_numpy, blocks),
                                    occ_budget=H)
    return [np.asarray(w) for w in want], got


@pytest.mark.parametrize("H", [0, 37, 400, 2000])
def test_expand_resolve_plain_matches(H):
    """Budgets from none, through one that cuts a suffix of reads, to one
    that holds every occurrence; rows with ok_in false and n_seeds < S."""
    rng = np.random.default_rng(H)
    sa = rng.permutation(6000).astype(np.int32)
    blocks = seed_blocks(rng, 60, 9, len(sa))
    want, got = run_both(sa, blocks, H)
    for w, g in zip(want, got):
        assert g.dtype == torch.int32 and w.dtype == np.int32
        np.testing.assert_array_equal(g.numpy(), w)
    ok, tot, offs = tres.decode_resolved_counts(got[0].numpy())
    if 0 < H < offs[-1]:  # the reads that overflow the budget form a suffix
        fits = offs[1:] <= H
        assert fits.any() and not fits.all()
        assert (np.diff(fits.astype(int)) <= 0).all()
        assert (got[1].numpy()[offs[fits.sum()]:] == -1).all()


def test_decode_resolved_counts_matches():
    rng = np.random.default_rng(1)
    cnts = rng.integers(-30, 30, 200).astype(np.int32)
    for w, g in zip(jres.decode_resolved_counts(cnts), tres.decode_resolved_counts(cnts)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def compose_both(B, S, H, has_ok, pack16, all_flagged=False):
    rng = np.random.default_rng(7)
    sa = rng.permutation(3000).astype(np.int32)
    n_seeds, rpos, slen, k0, freq, ok_in = seed_blocks(rng, B, S, len(sa))
    if not has_ok:
        ok_in = np.ones(B, bool)
    if all_flagged:
        ok_in = np.zeros(B, bool)
    cols = [n_seeds[:, None]] + ([ok_in.astype(np.int32)[:, None]] if has_ok else [])
    packed = np.concatenate(cols + [rpos, slen, k0, freq], axis=1).astype(np.int32)
    want_t, _ = run_both(sa, (n_seeds, rpos, slen, k0, freq, ok_in), H)
    want = np.asarray(jpack._pack_stream(*map(jnp.asarray, want_t), pack16=pack16))
    got = tres.resolve_pack_plain(torch.from_numpy(sa), torch.from_numpy(packed), max_seeds=S,
                                  has_ok=has_ok, occ_budget=H, pack16=pack16)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    return got.numpy()


@pytest.mark.parametrize("has_ok", [True, False])
@pytest.mark.parametrize("pack16", [False, True])
def test_resolve_pack_plain_composes(has_ok, pack16):
    """resolve_pack_plain on a packed seed array (the funnel's layout with
    the ok column, or the FM stepper's without) equals kart_tpu's
    expand_resolve followed by _pack_stream."""
    compose_both(40, 6, 90, has_ok, pack16)


@pytest.mark.parametrize("name, B, H, pack16, all_flagged", [
    ("block_plus_one", 258, 700, True, False),  # one read past a scan block of 256
    ("several_blocks_ragged", 1000, 2500, True, False),
    ("budget_zero", 300, 0, True, False),
    ("budget_zero_plain_layout", 257, 0, False, False),
    ("all_flagged", 300, 1200, False, True),
    ("all_flagged_pack16", 514, 1500, True, True),
])
def test_resolve_pack_plain_shapes_of_the_chained_scan(name, B, H, pack16, all_flagged):
    """The shapes the CUDA kernel's grid-wide totals pass treats apart (256
    reads a block): B not a multiple of the block, no budget at all, every
    read flagged.  The plain version must equal kart_tpu there, since the
    card's kernel is held against it."""
    got = compose_both(B, 6, H, True, pack16, all_flagged)
    cnts, meta, gpos = tpack.unpack_stream(got, B, H, pack16)
    if all_flagged or H == 0:
        ok, tot, _ = tres.decode_resolved_counts(cnts)
        assert not ok[tot > 0].any()
    if H == 0:
        assert len(gpos) == 0
