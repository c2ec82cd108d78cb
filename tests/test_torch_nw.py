"""The port's NW planes (kart_tpu_torch.ops.nw) against kart_tpu's Pallas
kernels in interpret mode and the host DP.  Outputs are integers and the
doubled-integer DP is exact, so every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kart_tpu.ops import nw as jax_nw
from kart_tpu.pipeline.conquer import nw_alignment
from kart_tpu_torch import kernels
from kart_tpu_torch.ops import nw as torch_nw

from test_nw_kernel import random_pairs

torch.set_num_threads(1)


@pytest.mark.parametrize("lm", [16, 32, 64, 128])
def test_planes_match_jax_kernels(lm):
    rng = np.random.default_rng(100 + lm)
    pairs = random_pairs(24, rng, max_len=lm, with_n=True)
    pairs = [p for p in pairs if max(map(len, p)) <= lm]
    pairs += [(b"A" * lm, b"C"), (b"N" * 3, b"NAN"), (b"", b"ACG")]
    c1, c2 = torch_nw.encode_tile(pairs, lm)
    if lm in (16, 32):
        want = np.asarray(
            jax_nw.nw_batch_planes(jnp.asarray(c1), jnp.asarray(c2), lm=lm, interpret=True)
        )
    else:
        want = jax_nw.nw_batch_planes_wave(jnp.asarray(c1), jnp.asarray(c2), lm=lm, interpret=True)
    got = torch_nw.nw_batch_planes(torch.from_numpy(c1), torch.from_numpy(c2), lm=lm)
    assert got.dtype == torch.uint8 and got.shape == (len(pairs), lm + 1, lm + 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_align_batch_matches_host_dp():
    rng = np.random.default_rng(7)
    pairs = random_pairs(200, rng)
    pairs += random_pairs(40, rng, max_len=128, with_n=True)
    # empty and one-base tails: the walk runs along the tile's boundary
    pairs += [(b"", b"ACG"), (b"ACG", b""), (b"A", b"ACGTACGT"), (b"ACGTACGT", b"T")]
    pairs += [(b"ACGT" * 40, b"ACGT" * 35)]  # longer than 128: host DP
    n_host = sum(max(len(a), len(b)) > 128 for a, b in pairs)
    before = dict(torch_nw.nw_stats)
    got = torch_nw.nw_align_batch(pairs, device="cpu")
    assert torch_nw.nw_stats["host"] - before["host"] == n_host == 1
    assert torch_nw.nw_stats["device"] - before["device"] == len(pairs) - n_host
    for k, (a, b) in enumerate(pairs):
        assert got[k] == nw_alignment(a, b), (k, a, b)
    assert torch_nw.nw_align_batch([], device="cpu") == []


def test_planes_reject_unsupported_tile():
    c = torch.zeros((2, 48), dtype=torch.int8)
    with pytest.raises(ValueError):
        torch_nw.nw_batch_planes(c, c, lm=48)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never runs the plain version: a CPU tensor raises
    before anything is built or launched."""
    c = torch.zeros((2, 16), dtype=torch.int8)
    before = kernels.nw_planes.launches
    with pytest.raises(ValueError, match="cuda"):
        kernels.nw_planes(c, c, lm=16)
    assert kernels.nw_planes.launches == before
