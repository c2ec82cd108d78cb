"""The port's read packing, read unpack and stream packing against
kart_tpu's (`kart_tpu/ops/pack.py`), exactly, with dtypes asserted."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kart_tpu.ops import pack as jpack
from kart_tpu_torch.ops import pack as tpack

torch.set_num_threads(1)


def random_codes(rng, B, L, n_frac=0.01):
    reads = rng.integers(0, 4, (B, L)).astype(np.int8)
    reads[rng.random((B, L)) < n_frac] = 4
    return reads


@pytest.mark.parametrize("B, L, n_frac", [(7, 64, 0.0), (33, 150, 0.01), (64, 160, 0.2)])
def test_pack_reads_2bit_matches(B, L, n_frac):
    reads = random_codes(np.random.default_rng(B), B, L, n_frac)
    want = jpack.pack_reads_2bit(reads)
    got = tpack.pack_reads_2bit(reads)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("B, L, n_frac", [(7, 64, 0.0), (33, 150, 0.01), (64, 160, 0.2)])
def test_pack_reads_2bit_plain_matches(B, L, n_frac):
    """The numpy packer is the plain version of the C++ packer: the same
    arrays, also for a batch that is not contiguous."""
    reads = random_codes(np.random.default_rng(B), B, L, n_frac)
    want = jpack.pack_reads_2bit(reads)
    wide = np.full((B, L + 5), 1, np.int8)
    wide[:, :L] = reads
    for got in (tpack.pack_reads_2bit_plain(reads), tpack.pack_reads_2bit(wide[:, :L])):
        for w, g in zip(want, got):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("l_max", [64, 160, 256])
def test_unpack_reads_plain_matches(l_max):
    """Including the pad entries of the ambiguity list (row B, dropped)."""
    rng = np.random.default_rng(l_max)
    B = 21
    reads = random_codes(rng, B, l_max, 0.02)
    words, amb_r, amb_p = jpack.pack_reads_2bit(reads)
    assert len(amb_r) > (amb_r < B).sum(), "the list must carry pad entries"
    want = np.asarray(jpack.unpack_reads_device(jnp.asarray(words), jnp.asarray(amb_r),
                                                jnp.asarray(amb_p), l_max))
    got = tpack.unpack_reads_plain(torch.from_numpy(words.view(np.int32)), torch.from_numpy(amb_r),
                                   torch.from_numpy(amb_p), l_max)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[(reads > 3)], 4)


def stream_parts(rng, B, H):
    """A resolved stream triple with flagged (negative) counts and the -1
    fill past the last occurrence."""
    cnts = rng.integers(0, 40, B).astype(np.int32)
    flag = rng.random(B) < 0.3
    cnts[flag] = -cnts[flag] - 1
    n = H - 5
    meta = np.full(H, -1, np.int32)
    meta[:n] = rng.integers(0, 256, n) | (rng.integers(13, 257, n) << 16)
    gpos = np.full(H, -1, np.int32)
    gpos[:n] = rng.integers(0, 10**7, n)
    return cnts, meta, gpos


@pytest.mark.parametrize("pack16", [False, True])
def test_pack_stream_plain_matches(pack16):
    cnts, meta, gpos = stream_parts(np.random.default_rng(5), 32, 48)
    want = np.asarray(jpack._pack_stream(jnp.asarray(cnts), jnp.asarray(meta), jnp.asarray(gpos),
                                         pack16=pack16))
    got = tpack.pack_stream_plain(torch.from_numpy(cnts), torch.from_numpy(meta),
                                  torch.from_numpy(gpos), pack16=pack16)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if pack16:  # the -1 meta fill becomes 0xFEFF (kart_tpu's pack16 loses it)
        mw = got.numpy()[16:40].view(np.uint16)
        assert (mw[-5:] == 0xFEFF).all()


@pytest.mark.parametrize("pack16", [False, True])
def test_unpack_stream_matches(pack16):
    cnts, meta, gpos = stream_parts(np.random.default_rng(6), 40, 64)
    packed = np.asarray(jpack._pack_stream(jnp.asarray(cnts), jnp.asarray(meta),
                                           jnp.asarray(gpos), pack16=pack16))
    want = jpack.unpack_stream(packed, 40, 64, pack16)
    got = tpack.unpack_stream(packed, 40, 64, pack16)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], cnts)
